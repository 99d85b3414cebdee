"""GLB writer: engine meshes (+ materials, textures, node hierarchy) ->
glTF 2.0 binary.

Port of ``syzygy_tpu/assets/gltf_export.py``; textures are encoded with
the port's own PNG encoder (``utils/png.py``, filter 0) where the
reference uses PIL. The engine is +y down and glTF +y up: the writer
flips y on positions, normals and node translations, so that
``gltf.load_gltf_meshes`` / ``load_gltf_scene`` (which apply the engine's
Y-flip) give back the original data.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from syzygy_tpu_torch.assets.types import Mesh, TextureLibrary, linear_to_srgb
from syzygy_tpu_torch.utils.png import encode_png


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


def write_glb(
    path: str,
    meshes: list[Mesh],
    library: TextureLibrary | None = None,
    nodes: list[dict] | None = None,
) -> None:
    """Write :func:`encode_glb`'s bytes to ``path``."""
    with open(path, "wb") as f:
        f.write(encode_glb(meshes, library, nodes))
