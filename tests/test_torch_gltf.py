"""The port's PNG codec, glTF loader and GLB writer vs the JAX package's.

Every .glb that ``tests/test_gltf.py`` builds goes through both loaders;
meshes (positions, normals, uvs, colors, triangles, surfaces) and the
texture atlas must agree bitwise, and both must warn or refuse alike.
The JAX loader decodes images with PIL, the port with its own codec.
"""

from __future__ import annotations

import base64
import io
import json
import logging

import numpy as np
import pytest
from PIL import Image

import test_gltf as ref_cases
from syzygy_tpu.assets import gltf as ref_gltf
from syzygy_tpu_torch.assets import gltf as port_gltf
from syzygy_tpu_torch.utils.png import decode_png, encode_png

# --------------------------------------------------------------------------
# PNG codec
# --------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [3, 4])
def test_png_bytes_roundtrip(channels):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=(29, 41, channels), dtype=np.uint8)
    back = decode_png(encode_png(img))
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()


def _smooth_image(h, w, seed):
    """Gradients plus noise, so PIL's adaptive filtering picks Sub, Up,
    Average and Paeth rows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 3 + y, y * 5, (x * y) // 7, 255 - x], axis=-1)
    return ((base + rng.integers(0, 4, size=(h, w, 4))) % 256).astype(np.uint8)


@pytest.mark.parametrize("mode", ["RGBA", "RGB", "LA", "L"])
def test_decode_png_matches_pil(mode):
    """PIL-encoded images (adaptive row filters) decode as PIL reads them."""
    pil = Image.fromarray(_smooth_image(48, 40, 1), "RGBA").convert(mode)
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    data = buf.getvalue()
    raw = __import__("zlib").decompress(b"".join(_idat_chunks(data)))
    stride = 40 * {"RGBA": 4, "RGB": 3, "LA": 2, "L": 1}[mode] + 1
    filters = {raw[i] for i in range(0, len(raw), stride)}
    assert len(filters) > 1, f"PIL used only filter {filters}"
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"), np.uint8)
    np.testing.assert_array_equal(decode_png(data), want)


def _idat_chunks(data):
    pos = 8
    while pos < len(data):
        length = int.from_bytes(data[pos : pos + 4], "big")
        if data[pos + 4 : pos + 8] == b"IDAT":
            yield data[pos + 8 : pos + 8 + length]
        pos += 12 + length


def test_decode_png_refuses_unsupported():
    pil = Image.fromarray(_smooth_image(8, 8, 2)[..., :3], "RGB").convert("P")
    buf = io.BytesIO()
    pil.save(buf, format="PNG")
    with pytest.raises(ValueError):
        decode_png(buf.getvalue())
    with pytest.raises(ValueError):
        decode_png(b"GIF89a")


# --------------------------------------------------------------------------
# the loader, on the files tests/test_gltf.py builds
# --------------------------------------------------------------------------


def _accessor_case(attr_name, raw, comp, acc_type, normalized=True):
    def build(tmp_path):
        b = ref_cases._GLBBuilder()
        acc = b.accessor(
            bufferView=b.view(raw.tobytes()), componentType=comp, count=raw.shape[0],
            type=acc_type, normalized=normalized,
        )
        prim = ref_cases._tri_prim(b, {attr_name: acc})
        return ref_cases._wrap_glb(tmp_path, b.gltf([prim]), b.binary())

    return build


def _sparse_case(with_base):
    def build(tmp_path):
        b = ref_cases._GLBBuilder()
        s_val = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
        s_idx = np.array([1, 3], np.uint16)
        spec = dict(
            componentType=5126, count=4, type="VEC3",
            sparse={
                "count": 2,
                "indices": {"bufferView": b.view(s_idx.tobytes()), "componentType": 5123},
                "values": {"bufferView": b.view(s_val.tobytes())},
            },
        )
        if with_base:
            spec["bufferView"] = b.view(np.full((4, 3), 0.5, np.float32).tobytes())
        pos_acc = b.accessor(**spec)
        idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
        idx_acc = b.accessor(bufferView=b.view(idx.tobytes()), componentType=5123, count=6, type="SCALAR")
        prim = {"attributes": {"POSITION": pos_acc}, "indices": idx_acc}
        return ref_cases._wrap_glb(tmp_path, b.gltf([prim]), b.binary())

    return build


def _interleaved(tmp_path):
    b = ref_cases._GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    uv8 = np.array([[0, 51], [102, 153], [204, 255]], np.uint8)
    raw = b"".join(pos[i].tobytes() + uv8[i].tobytes() + b"\x00\x00" for i in range(3))
    view = b.view(raw, stride=16)
    pos_acc = b.accessor(bufferView=view, byteOffset=0, componentType=5126, count=3, type="VEC3")
    uv_acc = b.accessor(bufferView=view, byteOffset=12, componentType=5121, count=3, type="VEC2", normalized=True)
    idx_acc = b.accessor(
        bufferView=b.view(np.array([0, 1, 2], np.uint16).tobytes()), componentType=5123, count=3, type="SCALAR"
    )
    prim = {"attributes": {"POSITION": pos_acc, "TEXCOORD_0": uv_acc}, "indices": idx_acc}
    return ref_cases._wrap_glb(tmp_path, b.gltf([prim]), b.binary())


def _index_width(comp, dtype):
    def build(tmp_path):
        b = ref_cases._GLBBuilder()
        pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], np.float32)
        idx = np.array([0, 1, 2, 2, 1, 3], dtype)
        pos_acc = b.accessor(bufferView=b.view(pos.tobytes()), componentType=5126, count=4, type="VEC3")
        idx_acc = b.accessor(bufferView=b.view(idx.tobytes()), componentType=comp, count=6, type="SCALAR")
        prim = {"attributes": {"POSITION": pos_acc}, "indices": idx_acc}
        return ref_cases._wrap_glb(tmp_path, b.gltf([prim]), b.binary())

    return build


def _non_indexed(tmp_path):
    b = ref_cases._GLBBuilder()
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    pos_acc = b.accessor(bufferView=b.view(pos.tobytes()), componentType=5126, count=3, type="VEC3")
    prims = [{"attributes": {"POSITION": pos_acc}}, ref_cases._tri_prim(b, {})]
    return ref_cases._wrap_glb(tmp_path, b.gltf(prims), b.binary())


def _lines_mode(tmp_path):
    b = ref_cases._GLBBuilder()
    prim = ref_cases._tri_prim(b, {})
    prim["mode"] = 1
    return ref_cases._wrap_glb(tmp_path, b.gltf([prim]), b.binary())


def _tangent_uv1_data_uri(tmp_path):
    b = ref_cases._GLBBuilder()
    tan = b.accessor(
        bufferView=b.view(np.tile(np.array([[1, 0, 0, 1]], np.float32), (3, 1)).tobytes()),
        componentType=5126, count=3, type="VEC4",
    )
    uv1 = b.accessor(bufferView=b.view(np.zeros((3, 2), np.float32).tobytes()), componentType=5126, count=3, type="VEC2")
    prim = ref_cases._tri_prim(b, {"TANGENT": tan, "TEXCOORD_1": uv1})
    prim["material"] = 0
    gltf = b.gltf([prim])
    buf = io.BytesIO()
    Image.fromarray(_smooth_image(6, 5, 3), "RGBA").save(buf, "PNG")
    gltf["images"] = [{"uri": "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()}]
    gltf["textures"] = [{"source": 0}]
    gltf["materials"] = [{"pbrMetallicRoughness": {"baseColorTexture": {"index": 0, "texCoord": 1}}}]
    return ref_cases._wrap_glb(tmp_path, gltf, b.binary())


def _occlusion_only_external(tmp_path):
    """An occlusion-only material whose image is an external file, and a
    buffer given as a data URI (JSON .gltf, no GLB container)."""
    b = ref_cases._GLBBuilder()
    prim = ref_cases._tri_prim(b, {})
    prim["material"] = 0
    gltf = b.gltf([prim])
    gltf["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(b.binary()).decode()
    Image.fromarray(_smooth_image(7, 9, 4), "RGBA").save(tmp_path / "occ.png")
    gltf["images"] = [{"uri": "occ.png"}]
    gltf["textures"] = [{"source": 0}]
    gltf["materials"] = [{"occlusionTexture": {"index": 0}}]
    path = tmp_path / "occ.gltf"
    path.write_text(json.dumps(gltf))
    return str(path)


CASES = {
    "textured_quad": lambda p: ref_cases.build_test_glb(p),
    "untextured_quad": lambda p: ref_cases.build_test_glb(p, with_texture=False),
    "normalized_u8_uv": _accessor_case(
        "TEXCOORD_0", np.array([[0, 255], [128, 0], [255, 128]], np.uint8), 5121, "VEC2"
    ),
    "normalized_u16_color": _accessor_case(
        "COLOR_0", np.array([[0, 65535, 32768], [65535, 0, 0], [1000, 2000, 3000]], np.uint16), 5123, "VEC3"
    ),
    "normalized_i8_normal": _accessor_case(
        "NORMAL", np.array([[127, 0, 0], [0, -127, 0], [0, 0, -128]], np.int8), 5120, "VEC3"
    ),
    "sparse_positions": _sparse_case(with_base=True),
    "sparse_without_base": _sparse_case(with_base=False),
    "interleaved_normalized": _interleaved,
    "u8_indices": _index_width(5121, np.uint8),
    "u32_indices": _index_width(5125, np.uint32),
    "non_indexed_skipped": _non_indexed,
    "lines_mode_as_triangles": _lines_mode,
    "tangent_uv1_data_uri": _tangent_uv1_data_uri,
    "occlusion_only_external": _occlusion_only_external,
}


def assert_meshes_equal(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        for name in ("positions", "normals", "uvs", "colors", "triangles"):
            a, b = getattr(p, name), getattr(r, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert p.name == r.name
        assert [(s.first_tri, s.tri_count, s.material.color, s.material.normal, s.material.orm) for s in p.surfaces] == [
            (s.first_tri, s.tri_count, s.material.color, s.material.normal, s.material.orm) for s in r.surfaces
        ]


def assert_libraries_equal(port, ref):
    assert len(port) == len(ref)
    for i in range(len(ref)):
        np.testing.assert_array_equal(port.get(i), ref.get(i), err_msg=f"texture {i}")
    p_atlas, p_rects = port.as_atlas()
    r_atlas, r_rects = ref.as_atlas()
    np.testing.assert_array_equal(p_rects, r_rects)
    np.testing.assert_array_equal(p_atlas, r_atlas)


def _log_messages(caplog):
    return sorted(r.getMessage() for r in caplog.records if r.name == "syzygy")


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_matches_reference(case, tmp_path, caplog):
    path = CASES[case](tmp_path)
    with caplog.at_level(logging.WARNING, logger="syzygy"):
        ref_meshes, ref_lib = ref_gltf.load_gltf_meshes(path)
    ref_log = _log_messages(caplog)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="syzygy"):
        port_meshes, port_lib = port_gltf.load_gltf_meshes(path)
    assert _log_messages(caplog) == ref_log
    assert_meshes_equal(port_meshes, ref_meshes)
    assert_libraries_equal(port_lib, ref_lib)


def test_required_extension_refused(tmp_path):
    b = ref_cases._GLBBuilder()
    gltf = b.gltf([ref_cases._tri_prim(b, {})])
    gltf["extensionsRequired"] = ["KHR_draco_mesh_compression"]
    gltf["extensionsUsed"] = ["KHR_draco_mesh_compression"]
    path = ref_cases._wrap_glb(tmp_path, gltf, b.binary())
    for loader in (ref_gltf.load_gltf_meshes, port_gltf.load_gltf_meshes):
        with pytest.raises(ValueError, match="KHR_draco_mesh_compression"):
            loader(path)
    del gltf["extensionsRequired"]  # used, not required: loads
    path = ref_cases._wrap_glb(tmp_path, gltf, b.binary(), "used_only.glb")
    assert len(port_gltf.load_gltf_meshes(path)[0]) == 1


def assert_scenes_equal(port, ref):
    assert len(port.geometry) == len(ref.geometry)
    for p, r in zip(port.geometry, ref.geometry):
        assert p.name == r.name
        assert_meshes_equal([p.mesh], [r.mesh])
        for name in ("translations", "eulers", "scales"):
            np.testing.assert_array_equal(getattr(p, name), getattr(r, name), err_msg=name)


def test_scene_node_transform_matches_reference(tmp_path):
    path = ref_cases.build_test_glb(tmp_path, node_translation=(5.0, 2.0, 0.0))
    port, port_lib = port_gltf.load_gltf_scene(path)
    ref, ref_lib = ref_gltf.load_gltf_scene(path)
    assert_scenes_equal(port, ref)
    assert_libraries_equal(port_lib, ref_lib)


def test_repo_sphere_glb_matches_reference():
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "assets", "sphere.glb")
    port, port_lib = port_gltf.load_gltf_scene(path)
    ref, ref_lib = ref_gltf.load_gltf_scene(path)
    assert port.geometry[0].mesh.triangles.shape[0] > 1000
    assert_scenes_equal(port, ref)
    assert_libraries_equal(port_lib, ref_lib)


# --------------------------------------------------------------------------
# the writer: its files load in the JAX loader to the same data
# --------------------------------------------------------------------------


def test_port_writer_loads_in_reference(tmp_path):
    """A textured, multi-surface, node-hierarchy .glb written by the port
    loads in the JAX loader (PIL decoding the port's PNGs) exactly as in
    the port's loader, and gives back the written meshes."""
    from syzygy_tpu_torch.assets.defaults import register_default_textures, sphere_mesh
    from syzygy_tpu_torch.assets.gltf_export import write_glb
    from syzygy_tpu_torch.assets.types import GeometrySurface, MaterialData, Mesh, TextureLibrary

    lib = TextureLibrary()
    default = register_default_textures(lib)
    odd = MaterialData(
        color=lib.register("odd_color", _smooth_image(12, 20, 5), srgb=True),
        normal=default.normal,
        orm=lib.register("odd_orm", _smooth_image(6, 10, 6)),
    )
    sphere = sphere_mesh(default, rings=6, segments=8)
    n_tris = sphere.triangles.shape[0]
    two = Mesh(
        sphere.positions, sphere.normals, sphere.uvs, sphere.colors, sphere.triangles,
        [GeometrySurface(0, n_tris // 2, default), GeometrySurface(n_tris // 2, n_tris - n_tris // 2, odd)],
        "two_surfaces",
    )
    nodes = [{
        "mesh": 0, "name": "root", "translation": (1.0, -2.0, 3.0),
        "children": [
            {"mesh": 1, "name": "turned", "translation": (4.0, 0.0, 0.0), "rotation_y": np.pi / 2},
            {"mesh": 1, "name": "scaled", "translation": (0.0, 0.0, 4.0), "scale": (2.0, 2.0, 2.0)},
        ],
    }]
    path = str(tmp_path / "written.glb")
    write_glb(path, [sphere, two], library=lib, nodes=nodes)

    ref_meshes, ref_lib = ref_gltf.load_gltf_meshes(path)
    port_meshes, port_lib = port_gltf.load_gltf_meshes(path)
    assert_meshes_equal(port_meshes, ref_meshes)
    assert_libraries_equal(port_lib, ref_lib)
    for name in ("positions", "normals", "uvs", "triangles"):
        np.testing.assert_array_equal(getattr(port_meshes[0], name), getattr(sphere, name))
    # one primitive per surface, each carrying the whole vertex arrays
    n_verts = sphere.positions.shape[0]
    np.testing.assert_array_equal(port_meshes[1].positions, np.concatenate([two.positions] * 2))
    np.testing.assert_array_equal(
        port_meshes[1].triangles, np.concatenate([two.triangles[: n_tris // 2], two.triangles[n_tris // 2 :] + n_verts])
    )
    # the loaded textures are the written ones, through the sRGB/u8 round trip
    odd_loaded = port_meshes[1].surfaces[1].material
    np.testing.assert_allclose(port_lib.get(odd_loaded.orm)[..., 1:], lib.get(odd.orm)[..., 1:], atol=0.5 / 255)

    port_scene, _ = port_gltf.load_gltf_scene(path)
    ref_scene, _ = ref_gltf.load_gltf_scene(path)
    assert_scenes_equal(port_scene, ref_scene)


def test_port_writer_matches_reference_writer(tmp_path):
    """The JAX writer and the port's writer describe the same file: their
    JSON chunks agree but for the generator name, and both load to the
    same meshes and textures."""
    from syzygy_tpu.assets import TextureLibrary as RefLibrary
    from syzygy_tpu.assets import register_default_textures as ref_defaults
    from syzygy_tpu.assets import sphere_mesh as ref_sphere
    from syzygy_tpu.assets.gltf_export import write_glb as ref_write

    from syzygy_tpu_torch.assets.defaults import register_default_textures, sphere_mesh
    from syzygy_tpu_torch.assets.gltf_export import write_glb
    from syzygy_tpu_torch.assets.types import TextureLibrary

    ref_lib = RefLibrary()
    ref_write(str(tmp_path / "ref.glb"), [ref_sphere(ref_defaults(ref_lib), 5, 7)], library=ref_lib)
    lib = TextureLibrary()
    write_glb(str(tmp_path / "port.glb"), [sphere_mesh(register_default_textures(lib), 5, 7)], library=lib)
    ref_json, _ = ref_gltf.parse_glb((tmp_path / "ref.glb").read_bytes())
    port_json, _ = port_gltf.parse_glb((tmp_path / "port.glb").read_bytes())
    for doc in (ref_json, port_json):
        del doc["asset"]["generator"]
        for view in doc["bufferViews"]:  # PNG streams differ in size
            view.pop("byteOffset"), view.pop("byteLength")
        del doc["buffers"]
    assert port_json == ref_json
    m_ref, l_ref = ref_gltf.load_gltf_meshes(str(tmp_path / "ref.glb"))
    m_port, l_port = port_gltf.load_gltf_meshes(str(tmp_path / "port.glb"))
    assert_meshes_equal(m_port, m_ref)
    assert_libraries_equal(l_port, l_ref)
