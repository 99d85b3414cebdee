"""GLB writer for the benchmark's scene inputs.

A frozen copy of the port's ``assets/gltf_export.py::encode_glb`` and its
PNG encoder (filter 0): meshes (one glTF primitive per surface),
materials with embedded PNG textures and a node hierarchy -> .glb bytes.
The engine is +y down and glTF +y up: the writer flips y on positions,
normals and node translations, so that a loader that applies the
engine's Y-flip gets the original data back.
"""

from __future__ import annotations

import json
import struct
import zlib

import numpy as np

from frame_bench.reference.assets.types import Mesh, TextureLibrary, linear_to_srgb

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(image: np.ndarray, compress_level: int = 6) -> bytes:
    """image: (H, W, 3|4) float in [0, 1] (rounded like the reference's
    writer) or uint8 -> PNG bytes, deflated at ``compress_level`` (1 is
    the fastest, for frames that are viewed once)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim != 3 or arr.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) image, got {arr.shape}")
    h, w, c = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return b"".join([
        _SIGNATURE,
        _chunk(b"IHDR", header),
        _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level)),
        _chunk(b"IEND", b""),
    ])


def encode_glb(
    meshes: list[Mesh],
    library: TextureLibrary | None = None,
    nodes: list[dict] | None = None,
) -> bytes:
    """Meshes (one glTF primitive per surface) -> .glb bytes.

    ``library``: when given, each surface's MaterialData becomes a
    pbrMetallicRoughness material with embedded PNG textures (baseColor
    re-encoded sRGB, normal/ORM linear; the ORM image doubles as
    occlusionTexture and metallicRoughnessTexture).

    ``nodes``: optional hierarchy, a list of scene-root dicts
    ``{"mesh": int|None, "name": str, "translation": (x,y,z) engine coords,
    "scale": (sx,sy,sz), "rotation_y": radians (engine, +y down),
    "children": [...]}``. Default: one root node per mesh.
    """
    bin_parts: list[bytes] = []
    views = []
    accessors = []

    def add_view(raw: bytes) -> int:
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(raw + b"\x00" * ((-len(raw)) % 4))
        views.append({"buffer": 0, "byteOffset": offset, "byteLength": len(raw)})
        return len(views) - 1

    def add(arr: np.ndarray, acc_type: str, comp: int, minmax=False):
        view = add_view(np.ascontiguousarray(arr).tobytes())
        acc = {"bufferView": view, "componentType": comp, "count": int(arr.shape[0]), "type": acc_type}
        if minmax:
            acc["min"] = np.asarray(arr).min(axis=0).tolist()
            acc["max"] = np.asarray(arr).max(axis=0).tolist()
        accessors.append(acc)
        return len(accessors) - 1

    # --- materials / textures ---------------------------------------------
    images: list[dict] = []
    textures: list[dict] = []
    materials: list[dict] = []
    material_index: dict[tuple[int, int, int], int] = {}
    texture_index: dict[tuple[int, bool], int] = {}

    def emit_texture(tex_id: int, srgb: bool) -> int:
        key = (tex_id, srgb)
        if key in texture_index:
            return texture_index[key]
        tex = library.get(tex_id)
        rgb = linear_to_srgb(tex[..., :3]) if srgb else tex[..., :3]
        u8 = np.concatenate([rgb, tex[..., 3:]], axis=-1)
        u8 = np.clip(np.round(u8 * 255.0), 0, 255).astype(np.uint8)
        view = add_view(encode_png(u8))
        images.append({"bufferView": view, "mimeType": "image/png"})
        textures.append({"source": len(images) - 1})
        texture_index[key] = len(textures) - 1
        return texture_index[key]

    def emit_material(mat) -> int:
        key = (mat.color, mat.normal, mat.orm)
        if key in material_index:
            return material_index[key]
        color_t = emit_texture(mat.color, srgb=True)
        normal_t = emit_texture(mat.normal, srgb=False)
        orm_t = emit_texture(mat.orm, srgb=False)
        materials.append({
            "name": f"mat_{len(materials)}",
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": color_t},
                "metallicRoughnessTexture": {"index": orm_t},
            },
            "normalTexture": {"index": normal_t},
            "occlusionTexture": {"index": orm_t},
        })
        material_index[key] = len(materials) - 1
        return material_index[key]

    # --- meshes -------------------------------------------------------------
    gltf_meshes = []
    flip = np.array([1.0, -1.0, 1.0], np.float32)
    for mesh in meshes:
        pos_acc = add((mesh.positions * flip).astype(np.float32), "VEC3", 5126, minmax=True)
        nrm_acc = add((mesh.normals * flip).astype(np.float32), "VEC3", 5126)
        uv_acc = add(mesh.uvs.astype(np.float32), "VEC2", 5126)
        if mesh.surfaces:
            ranges = [(s.first_tri, s.tri_count, s.material) for s in mesh.surfaces]
        else:
            ranges = [(0, mesh.triangles.shape[0], None)]
        primitives = []
        for first, count, material in ranges:
            idx = mesh.triangles[first : first + count].reshape(-1).astype(np.uint32)
            prim = {
                "attributes": {"POSITION": pos_acc, "NORMAL": nrm_acc, "TEXCOORD_0": uv_acc},
                "indices": add(idx[:, None], "SCALAR", 5125),
                "mode": 4,
            }
            if material is not None and library is not None:
                prim["material"] = emit_material(material)
            primitives.append(prim)
        gltf_meshes.append({"name": mesh.name, "primitives": primitives})

    # --- nodes --------------------------------------------------------------
    gltf_nodes: list[dict] = []

    def emit_node(spec: dict) -> int:
        node: dict = {"name": spec.get("name", f"node_{len(gltf_nodes)}")}
        if spec.get("mesh") is not None:
            node["mesh"] = int(spec["mesh"])
        t = spec.get("translation")
        if t is not None:
            node["translation"] = [float(t[0]), -float(t[1]), float(t[2])]
        s = spec.get("scale")
        if s is not None:
            node["scale"] = [float(v) for v in s]
        ry = spec.get("rotation_y")
        if ry is not None:
            # engine +y-down rotation by ry == glTF +y-up rotation by -ry
            half = -float(ry) / 2.0
            node["rotation"] = [0.0, float(np.sin(half)), 0.0, float(np.cos(half))]
        gltf_nodes.append(node)
        my_index = len(gltf_nodes) - 1
        children = [emit_node(c) for c in spec.get("children", [])]
        if children:
            gltf_nodes[my_index]["children"] = children
        return my_index

    if nodes is None:
        roots = [emit_node({"mesh": i, "name": m.name}) for i, m in enumerate(meshes)]
    else:
        roots = [emit_node(spec) for spec in nodes]

    gltf = {
        "asset": {"version": "2.0", "generator": "syzygy_tpu_torch"},
        "scene": 0,
        "scenes": [{"nodes": roots}],
        "nodes": gltf_nodes,
        "meshes": gltf_meshes,
        "buffers": [{"byteLength": sum(len(p) for p in bin_parts)}],
        "bufferViews": views,
        "accessors": accessors,
    }
    if materials:
        gltf["materials"] = materials
        gltf["textures"] = textures
        gltf["images"] = images
    json_bytes = json.dumps(gltf).encode()
    json_bytes += b" " * ((-len(json_bytes)) % 4)
    binary = b"".join(bin_parts)
    total = 12 + 8 + len(json_bytes) + 8 + len(binary)
    return b"".join([
        struct.pack("<III", 0x46546C67, 2, total),
        struct.pack("<II", len(json_bytes), 0x4E4F534A),
        json_bytes,
        struct.pack("<II", len(binary), 0x004E4942),
        binary,
    ])
