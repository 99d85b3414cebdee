"""glTF 2.0 / GLB loader (standard library + numpy).

Port of ``syzygy_tpu/assets/gltf.py`` (the reference asset path,
``assets/assets.cpp:1192-1283``), with images decoded by the port's own
PNG codec (``utils/png.py``) instead of PIL:

* GLB container, buffers (GLB BIN chunk, data URI, external file) and
  accessors the way fastgltf reads them: normalized integers, sparse
  substitution, interleaved (strided) views;
* materials: color maps decode as sRGB, normal/ORM as linear UNORM; the
  metallicRoughness texture becomes the ORM map with its occlusion
  channel saturated, an occlusion-only texture zeroes green/blue
  (``assets.cpp:550-572``);
* mesh primitives with the engine's Y-flip on positions and normals;
  non-indexed or position-less primitives warn and are skipped,
  non-Triangles modes warn and load as triangles;
* a file whose ``extensionsRequired`` names any extension is refused
  (fastgltf ``MissingExtensions``);
* :func:`load_gltf_scene` walks the node hierarchy and bakes each mesh
  node's world matrix into its own mesh copy.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import struct

import numpy as np

from frame_bench.reference.assets.defaults import register_default_textures
from frame_bench.reference.assets.types import GeometrySurface, MaterialData, Mesh, TextureLibrary
from frame_bench.reference.scene.scene import Scene, TransformHost
from frame_bench.reference.utils.png import decode_png

_log = logging.getLogger("syzygy")

# the reference's parser registers no extension, so any required one refuses
_SUPPORTED_REQUIRED_EXTENSIONS: frozenset[str] = frozenset()

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def parse_glb(data: bytes) -> tuple[dict, bytes]:
    """GLB container: 12-byte header + JSON chunk + optional BIN chunk."""
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:  # 'glTF'
        raise ValueError("not a GLB file")
    if version != 2:
        raise ValueError(f"unsupported GLB version {version}")
    offset = 12
    gltf_json = None
    binary = b""
    while offset < len(data):
        chunk_len, chunk_type = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8 : offset + 8 + chunk_len]
        if chunk_type == 0x4E4F534A:  # 'JSON'
            gltf_json = json.loads(chunk)
        elif chunk_type == 0x004E4942:  # 'BIN\0'
            binary = bytes(chunk)
        offset += 8 + chunk_len + (-chunk_len) % 4
    if gltf_json is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf_json, binary


class GLTFFile:
    """Parsed glTF with accessor/image readers. ``base_dir`` resolves
    external buffer and image URIs."""

    def __init__(self, gltf: dict, binary: bytes, base_dir: str):
        self.gltf = gltf
        self.binary = binary
        self.base_dir = base_dir
        self._buffer_cache: dict[int, bytes] = {}
        missing = [e for e in gltf.get("extensionsRequired", []) if e not in _SUPPORTED_REQUIRED_EXTENSIONS]
        if missing:
            raise ValueError(
                "glTF requires unsupported extensions (fastgltf "
                f"MissingExtensions semantics, assets.cpp:421): {missing}"
            )

    @staticmethod
    def from_bytes(data: bytes, base_dir: str) -> "GLTFFile":
        """A .glb or JSON .gltf held in memory."""
        if data[:4] == b"glTF":
            return GLTFFile(*parse_glb(data), base_dir)
        return GLTFFile(json.loads(data), b"", base_dir)

    @staticmethod
    def open(path: str) -> "GLTFFile":
        with open(path, "rb") as f:
            data = f.read()
        return GLTFFile.from_bytes(data, os.path.dirname(os.path.abspath(path)))

    def buffer(self, index: int) -> bytes:
        if index in self._buffer_cache:
            return self._buffer_cache[index]
        uri = self.gltf["buffers"][index].get("uri")
        if uri is None:
            data = self.binary
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, uri), "rb") as f:
                data = f.read()
        self._buffer_cache[index] = data
        return data

    def _read_view(self, view_index: int, byte_offset: int, count: int, n_comp: int, dtype) -> np.ndarray:
        """Dense (possibly interleaved/strided) bufferView read."""
        itemsize = np.dtype(dtype).itemsize * n_comp
        view = self.gltf["bufferViews"][view_index]
        data = self.buffer(view["buffer"])
        start = view.get("byteOffset", 0) + byte_offset
        stride = view.get("byteStride", itemsize)
        if stride == itemsize:
            arr = np.frombuffer(data, dtype, count=count * n_comp, offset=start).reshape(count, n_comp)
        else:
            rows = np.frombuffer(data, np.uint8, count=(count - 1) * stride + itemsize, offset=start)
            strided = np.lib.stride_tricks.as_strided(rows, (count, itemsize), (stride, 1))
            arr = strided.copy().view(dtype).reshape(count, n_comp)
        return np.array(arr)

    def accessor(self, index: int) -> np.ndarray:
        """Read an accessor as fastgltf's getAccessorElement does: a missing
        ``bufferView`` reads zeros, ``sparse`` substitutes on top, and
        ``normalized`` integers become f32 in [0, 1] (unsigned: v / max) or
        [-1, 1] (signed: max(v / max, -1))."""
        acc = self.gltf["accessors"][index]
        count = acc["count"]
        n_comp = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        if "bufferView" not in acc:
            arr = np.zeros((count, n_comp), dtype)
        else:
            arr = self._read_view(acc["bufferView"], acc.get("byteOffset", 0), count, n_comp, dtype)
        sparse = acc.get("sparse")
        if sparse:
            arr = arr.copy()
            s_count = sparse["count"]
            s_idx_spec = sparse["indices"]
            s_idx = self._read_view(
                s_idx_spec["bufferView"], s_idx_spec.get("byteOffset", 0), s_count, 1,
                _COMPONENT_DTYPES[s_idx_spec["componentType"]],
            ).reshape(-1).astype(np.int64)
            s_val_spec = sparse["values"]
            arr[s_idx] = self._read_view(
                s_val_spec["bufferView"], s_val_spec.get("byteOffset", 0), s_count, n_comp, dtype
            )
        if acc.get("normalized") and np.issubdtype(np.dtype(dtype), np.integer):
            info = np.iinfo(dtype)
            arr = arr.astype(np.float32) / np.float32(info.max)
            if info.min < 0:
                arr = np.maximum(arr, -1.0)
        return arr

    def image_rgba(self, image_index: int) -> np.ndarray:
        """Decode an image entry (PNG) to (H, W, 4) uint8."""
        img = self.gltf["images"][image_index]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                raw = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.base_dir, uri), "rb") as f:
                    raw = f.read()
        else:
            view = self.gltf["bufferViews"][img["bufferView"]]
            data = self.buffer(view["buffer"])
            start = view.get("byteOffset", 0)
            raw = data[start : start + view["byteLength"]]
        return decode_png(raw)


def _texture_image_index(gltf: dict, texture_index: int) -> int | None:
    """texture -> image indirection (``assets.cpp:434-468``)."""
    textures = gltf.get("textures", [])
    if texture_index >= len(textures):
        return None
    return textures[texture_index].get("source")


def _load_materials(f: GLTFFile, library: TextureLibrary, fallback: MaterialData, name_prefix: str) -> list[MaterialData]:
    """``uploadMaterialDataAsAssets`` (``assets.cpp:735-879``)."""

    def tex_index(info: dict, mi: int, what: str) -> int | None:
        idx = info.get("index")
        if idx is not None and info.get("texCoord", 0) != 0:
            _log.warning(
                "material %d %s uses TEXCOORD_%d; only UV set 0 is loaded, sampling with TEXCOORD_0",
                mi, what, info.get("texCoord"),
            )
        return idx

    materials = []
    for mi, mat in enumerate(f.gltf.get("materials", [])):
        pbr = mat.get("pbrMetallicRoughness", {})

        rm_tex = tex_index(pbr.get("metallicRoughnessTexture", {}), mi, "metallicRoughness")
        occ_tex = tex_index(mat.get("occlusionTexture", {}), mi, "occlusion")
        orm_id = fallback.orm
        src_tex = rm_tex if rm_tex is not None else occ_tex
        if src_tex is not None:
            image_index = _texture_image_index(f.gltf, src_tex)
            if image_index is not None:
                rgba = f.image_rgba(image_index).copy()
                if rm_tex is not None:
                    rgba[..., 0] = 255  # saturate occlusion (assets.cpp:781)
                else:
                    rgba[..., 1] = 0
                    rgba[..., 2] = 0
                orm_id = library.register(f"{name_prefix}_orm_{src_tex}_{rm_tex is not None}", rgba, srgb=False)

        color_id = fallback.color
        color_tex = tex_index(pbr.get("baseColorTexture", {}), mi, "baseColor")
        if color_tex is not None:
            image_index = _texture_image_index(f.gltf, color_tex)
            if image_index is not None:
                color_id = library.register(f"{name_prefix}_color_{color_tex}", f.image_rgba(image_index), srgb=True)

        normal_id = fallback.normal
        normal_tex = tex_index(mat.get("normalTexture", {}), mi, "normal")
        if normal_tex is not None:
            image_index = _texture_image_index(f.gltf, normal_tex)
            if image_index is not None:
                normal_id = library.register(f"{name_prefix}_normal_{normal_tex}", f.image_rgba(image_index), srgb=False)

        materials.append(MaterialData(color=color_id, normal=normal_id, orm=orm_id))
    return materials


def _load_meshes(f: GLTFFile, materials: list[MaterialData], fallback: MaterialData) -> list[Mesh]:
    """``loadMeshes`` (``assets.cpp:887-1091``): primitives -> surfaces,
    Y-flip on positions and normals."""
    meshes = []
    for mesh_idx, gmesh in enumerate(f.gltf.get("meshes", [])):
        positions, normals, uvs, colors, tris = [], [], [], [], []
        surfaces = []
        vert_base = 0
        tri_base = 0
        for prim in gmesh.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "indices" not in prim:
                _log.warning("glTF mesh primitive had no valid indices accessor. It will be skipped.")
                continue
            if "POSITION" not in attrs:
                _log.warning("glTF mesh primitive had no valid vertices accessor. It will be skipped.")
                continue
            if prim.get("mode", 4) != 4:
                _log.warning("Loading glTF mesh primitive as Triangles mode when it is not.")
            # TANGENT, TEXCOORD_1+ and skinning are ignored: the tangent frame
            # derives per pixel and only UV set 0 is sampled
            pos = f.accessor(attrs["POSITION"]).astype(np.float32)
            n = pos.shape[0]
            nrm = (
                f.accessor(attrs["NORMAL"]).astype(np.float32)
                if "NORMAL" in attrs
                else np.tile(np.array([[0, 0, 1]], np.float32), (n, 1))
            )
            uv = (
                f.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                if "TEXCOORD_0" in attrs
                else np.zeros((n, 2), np.float32)
            )
            if "COLOR_0" in attrs:
                col = f.accessor(attrs["COLOR_0"]).astype(np.float32)
                if col.shape[1] == 3:
                    col = np.concatenate([col, np.ones((n, 1), np.float32)], axis=1)
            else:
                col = np.ones((n, 4), np.float32)

            idx = f.accessor(prim["indices"]).astype(np.int64).reshape(-1)
            if idx.size % 3:  # non-Triangles modes may not divide by 3
                idx = idx[: idx.size - idx.size % 3]
            prim_tris = idx.reshape(-1, 3).astype(np.int32) + vert_base

            mat_index = prim.get("material")
            material = materials[mat_index] if mat_index is not None and mat_index < len(materials) else fallback
            surfaces.append(GeometrySurface(first_tri=tri_base, tri_count=len(prim_tris), material=material))
            positions.append(pos)
            normals.append(nrm)
            uvs.append(uv)
            colors.append(col)
            tris.append(prim_tris)
            vert_base += n
            tri_base += len(prim_tris)

        if not surfaces:
            continue
        pos = np.concatenate(positions)
        nrm = np.concatenate(normals)
        # FLIP_Y (assets.cpp:1052-1060)
        pos[:, 1] *= -1
        nrm[:, 1] *= -1
        meshes.append(Mesh(
            pos, nrm, np.concatenate(uvs), np.concatenate(colors), np.concatenate(tris),
            surfaces, gmesh.get("name", f"mesh_{mesh_idx}"),
        ))
    return meshes


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = np.eye(4, dtype=np.float32)
    t = node.get("translation", [0, 0, 0])
    x, y, z, w = node.get("rotation", [0, 0, 0, 1])  # xyzw
    s = node.get("scale", [1, 1, 1])
    rot = np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )
    m[:3, :3] = rot * np.asarray(s, np.float32)[None, :]
    m[:3, 3] = t
    return m


_FLIP_Y = np.diag(np.array([1.0, -1.0, 1.0, 1.0], np.float32))


def _prefix(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def load_gltf_meshes(path: str, library: TextureLibrary | None = None) -> tuple[list[Mesh], TextureLibrary]:
    """``loadGLTFFromPath`` (``assets.cpp:1192-1283``): meshes + textures."""
    library = library or TextureLibrary()
    fallback = register_default_textures(library)
    f = GLTFFile.open(path)
    materials = _load_materials(f, library, fallback, _prefix(path))
    return _load_meshes(f, materials, fallback), library


def load_gltf_scene(path: str, library: TextureLibrary | None = None) -> tuple[Scene, TextureLibrary]:
    """Load a .glb/.gltf file as a renderable Scene (:func:`gltf_scene`)."""
    return gltf_scene(GLTFFile.open(path), _prefix(path), library)


def gltf_scene(f: GLTFFile, prefix: str, library: TextureLibrary | None = None) -> tuple[Scene, TextureLibrary]:
    """A parsed glTF as a Scene: one instance per mesh node, its world
    matrix baked into a dedicated mesh copy (normals by the inverse
    transpose, renormalised) and the instance scale reset to 1
    (``syzygy_tpu/assets/gltf.py:452-533``). ``prefix`` names its
    textures and instances."""
    library = library or TextureLibrary()
    fallback = register_default_textures(library)
    materials = _load_materials(f, library, fallback, prefix)
    meshes = _load_meshes(f, materials, fallback)

    # glTF mesh index -> loaded Mesh (mirrors _load_meshes' skip rule)
    mesh_by_index: dict[int, Mesh] = {}
    li = 0
    for mi, gmesh in enumerate(f.gltf.get("meshes", [])):
        has_tris = any("POSITION" in p.get("attributes", {}) and "indices" in p for p in gmesh.get("primitives", []))
        if has_tris and li < len(meshes):
            mesh_by_index[mi] = meshes[li]
            li += 1

    scene = Scene()
    nodes = f.gltf.get("nodes", [])
    scenes = f.gltf.get("scenes", [])
    roots = scenes[f.gltf.get("scene", 0)]["nodes"] if scenes else range(len(nodes))
    instances: dict[int, list[np.ndarray]] = {}

    def walk(node_index: int, parent: np.ndarray):
        node = nodes[node_index]
        world = parent @ _node_matrix(node)
        if "mesh" in node and node["mesh"] in mesh_by_index:
            instances.setdefault(node["mesh"], []).append(world)
        for child in node.get("children", []):
            walk(child, world)

    for root in roots:
        walk(root, np.eye(4, dtype=np.float32))

    for mesh_index, mats in instances.items():
        mesh = mesh_by_index[mesh_index]
        for i, m in enumerate(mats):
            # glTF is +y up, the engine +y down: conjugate the node matrix so
            # the already-flipped mesh lands where the file puts it
            m_eng = _FLIP_Y @ m @ _FLIP_Y
            baked = Mesh(
                positions=(m_eng[:3, :3] @ mesh.positions.T).T + m_eng[:3, 3],
                normals=(np.linalg.inv(m_eng[:3, :3]).T @ mesh.normals.T).T.astype(np.float32),
                uvs=mesh.uvs,
                colors=mesh.colors,
                triangles=mesh.triangles,
                surfaces=mesh.surfaces,
                name=mesh.name,
            )
            norms = np.linalg.norm(baked.normals, axis=1, keepdims=True)
            baked.normals = (baked.normals / np.maximum(norms, 1e-12)).astype(np.float32)
            inst = scene.add_mesh_instance(baked, f"{prefix}_{mesh.name}_{i}", [TransformHost.make()])
            # the node transform is baked: undo setMesh's scale normalisation
            inst.scales[:] = 1.0
    return scene, library
