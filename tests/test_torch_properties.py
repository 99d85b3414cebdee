"""The property table and scene files of the port against the JAX
package's: ``format_table(discover(scene))`` text, dotted-path edits and
resets, ``apply_config_field``, and ``scene_to_dict``/``save_scene``/
``load_scene`` with files cross-loaded between the two packages. All
comparisons are exact (text and JSON equality, bitwise arrays).

Two faults of the reference are not inherited, each with a test where the
port refuses what the reference accepts: an int field truncates a float
with a fractional part, and ``apply_config_field`` installs a config that
``RenderConfig.check`` refuses.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)

torch.set_num_threads(2)

# the same edit sequences on both packages' scenes
EDITS = {
    "none": [],
    "edited": [
        "camera.fov_degrees=85.5",
        "sun_animation.frozen=true",
        "atmosphere.sun_euler_angles=[1.2, 0, 0.5]",
        "spotlights[0].strength=250",
        "geometry[1].animation=SPIN_ALONG_WORLD_UP",
        "geometry[0].transforms[0].translation=[5, -2, 3]",
        "render_atmosphere=false",
    ],
    "edited_then_reset": [
        "camera.fov_degrees=85.5",
        "geometry[0].transforms[0].translation=[5, -2, 3]",
        "geometry[2].transforms[0].scale=[1, 2, 3]",
        "camera.fov_degrees=default",
        "geometry[0].transforms[0].translation=default",
        "geometry[2].transforms[0].scale=default",
    ],
}


def _scenes(name):
    """(port scene, reference scene) of one builtin, built by each
    package's own host code."""
    from syzygy_tpu.app.scenes import builtin_scene as ref_builtin

    from syzygy_tpu_torch.app.scenes import builtin_scene

    return builtin_scene(name)[0], ref_builtin(name)[0]


@pytest.mark.parametrize("edits", list(EDITS))
@pytest.mark.parametrize("scene_name", ["default", "flagship"])
def test_property_table_text_equal(scene_name, edits):
    """The 3-column table prints the same text in both packages, before and
    after the same ``--set`` sequences (resets to the discovered defaults
    included)."""
    from syzygy_tpu.app.properties import apply_set as ref_apply_set
    from syzygy_tpu.app.properties import discover as ref_discover
    from syzygy_tpu.app.properties import format_table as ref_format_table

    from syzygy_tpu_torch.app.properties import apply_set, discover, format_table

    port, ref = _scenes(scene_name)
    for spec in EDITS[edits]:
        if scene_name == "flagship" and "spotlights" in spec:
            continue  # the flagship has no spotlight
        assert apply_set(port, spec) == ref_apply_set(ref, spec)
    text = format_table(discover(port))
    assert text == ref_format_table(ref_discover(ref))
    assert text.splitlines()[0].split() == ["property", "value", "default"]


def test_set_reset_and_paths():
    """The reference's edit semantics (``tests/test_properties.py:30-126``)
    on the port: camera alias, tuple/enum/bool coercion, writes through the
    SoA views, transform reset to the originals, bad paths."""
    from syzygy_tpu_torch.app.properties import apply_set, get_path, reset_path, set_path
    from syzygy_tpu_torch.scene.scene import InstanceAnimation, default_scene

    scene, _ = default_scene()
    apply_set(scene, "camera.fov_degrees=85.5")
    assert scene.camera.fov_degrees == 85.5
    apply_set(scene, "camera.fov_degrees=default")
    assert scene.camera.fov_degrees == 70.0
    set_path(scene, "atmosphere.sun_euler_angles", [1.2, 0, 0.5])
    assert scene.atmosphere.sun_euler_angles == (1.2, 0.0, 0.5)
    with pytest.raises(ValueError):
        set_path(scene, "atmosphere.sun_euler_angles", [1.0, 2.0])
    set_path(scene, "geometry[0].animation", "SPIN_ALONG_WORLD_UP")
    assert scene.geometry[0].animation is InstanceAnimation.SPIN_ALONG_WORLD_UP
    inst = scene.geometry[0]
    orig = inst.originals[0].translation.copy()
    set_path(scene, "geometry[0].transforms[0].translation", [9.0, 9.0, 9.0])
    np.testing.assert_array_equal(inst.translations[0], [9.0, 9.0, 9.0])
    reset_path(scene, "geometry[0].transforms[0].translation")
    np.testing.assert_array_equal(inst.translations[0], orig)
    set_path(scene, "render_atmosphere", "false")
    assert scene.render_atmosphere is False
    reset_path(scene, "render_atmosphere")
    assert scene.render_atmosphere is True
    assert get_path(scene, "camera_speed") == 20.0
    with pytest.raises(KeyError):
        get_path(scene, "cameras[0]")
    with pytest.raises((KeyError, AttributeError)):
        set_path(scene, "nonsense.path", 1)
    with pytest.raises(KeyError):
        reset_path(scene, "atmosphere.not_a_field")


def test_int_fields_refuse_fractions():
    """Not inherited: the reference truncates 1.5 to 1 for an int field
    (``properties.py:185`` and ``:283``); the port refuses it, and takes
    an integral float."""
    from syzygy_tpu.app.properties import apply_config_field as ref_apply_config_field
    from syzygy_tpu.app.properties import set_path as ref_set_path
    from syzygy_tpu.renderer import RenderConfig as RefConfig

    from syzygy_tpu_torch.app.properties import apply_config_field, set_path
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    port, ref = _scenes("default")
    port.add_camera()
    ref.add_camera()
    ref_set_path(ref, "camera_index", 1.5)
    assert ref.camera_index == 1  # the reference truncates
    with pytest.raises(ValueError):
        set_path(port, "camera_index", 1.5)
    set_path(port, "camera_index", 1.0)
    assert port.camera_index == 1 and isinstance(port.camera_index, int)
    assert ref_apply_config_field(RefConfig(), "shadow_dim", "256.7").shadow_dim == 256
    with pytest.raises(ValueError):
        apply_config_field(RenderConfig(), "shadow_dim", "256.7")
    assert apply_config_field(RenderConfig(), "shadow_dim", "256.0").shadow_dim == 256


@pytest.mark.parametrize("field, value", [("tile_list_capacity", "-1"), ("oetf", '"x"'), ("supersample", "-1"), ("n_shadow_maps", "-2")])
def test_config_edit_validated_whole(field, value):
    """Not inherited: the reference installs any config whose eight
    dimensions are positive (``properties.py:289-295``), so
    ``tile_list_capacity=-1`` or ``oetf="x"`` reaches the renderer; the port runs
    ``RenderConfig.check`` on the new config first and refuses it, leaving
    the old one as it was."""
    from syzygy_tpu.app.properties import apply_config_field as ref_apply_config_field
    from syzygy_tpu.renderer import RenderConfig as RefConfig

    from syzygy_tpu_torch.app.properties import apply_config_field
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    if field in ("tile_list_capacity", "oetf"):
        assert getattr(ref_apply_config_field(RefConfig(), field, value), field) != getattr(RefConfig(), field)
    config = RenderConfig()
    with pytest.raises(ValueError):
        apply_config_field(config, field, value)
    assert config == RenderConfig()


def test_apply_config_field():
    """The shared config edit core: reflected coercion, reset to the
    dataclass default, unknown names, the reference's own refusals."""
    from syzygy_tpu_torch.app.properties import apply_config_field
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    cfg = RenderConfig(width=128, height=64)
    c2 = apply_config_field(cfg, "oetf", "pure_gamma")
    assert c2.oetf == "pure_gamma" and cfg.oetf == "srgb"
    assert apply_config_field(c2, "oetf", "default").oetf == "srgb"
    assert apply_config_field(cfg, "pcf_f16", "False").pcf_f16 is False
    assert apply_config_field(cfg, "pcf_f16", "on").pcf_f16 is True
    assert apply_config_field(cfg, "shadow_dim", "256").shadow_dim == 256
    assert apply_config_field(cfg, "shadow_bias_slope", "-1.5").shadow_bias_slope == -1.5
    with pytest.raises(KeyError):
        apply_config_field(cfg, "nope", "1")
    with pytest.raises(ValueError):
        apply_config_field(cfg, "height", "0")
    assert apply_config_field(cfg, "pcf_q8", "true").pcf_q8 is True  # a former TPU-only mode


def _edited_pair():
    """The same edited default scene in both packages: a second camera, a
    material override, a frozen sun, a tick."""
    from syzygy_tpu.assets import MaterialData as RefMaterial
    from syzygy_tpu.scene.camera import Camera as RefCamera

    from syzygy_tpu_torch.assets.types import MaterialData
    from syzygy_tpu_torch.scene.camera import Camera

    port, ref = _scenes("default")
    for scene, Cam, Mat in ((port, Camera, MaterialData), (ref, RefCamera, RefMaterial)):
        scene.sun_animation.time = 0.123
        scene.camera.position = (1.0, -2.0, 3.0)
        scene.add_camera(Cam(position=(9.0, -9.0, 9.0), orthographic=True))
        scene.camera_index = 1
        scene.geometry[0].set_material_override(0, Mat(color=2, normal=1, orm=0))
        scene.tick(0.5)
    return port, ref


def test_scene_dict_equal():
    """``scene_to_dict`` gives the same JSON in both packages."""
    from syzygy_tpu.scene.serialize import scene_to_dict as ref_to_dict

    from syzygy_tpu_torch.scene.serialize import scene_to_dict

    port, ref = _edited_pair()
    assert json.dumps(scene_to_dict(port), sort_keys=True) == json.dumps(ref_to_dict(ref), sort_keys=True)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_scene_files_cross_load(tmp_path, writer):
    """A file either package writes loads in the other, and both packages
    write the loaded scene back as the same JSON; the loaded scenes pack
    the same frame parameters."""
    from syzygy_tpu.assets import TextureLibrary as RefLibrary
    from syzygy_tpu.assets import cube_mesh as ref_cube
    from syzygy_tpu.assets import plane_mesh as ref_plane
    from syzygy_tpu.assets import register_default_textures as ref_register
    from syzygy_tpu.scene import pack_frame_params as ref_pack
    from syzygy_tpu.scene.serialize import load_scene as ref_load
    from syzygy_tpu.scene.serialize import save_scene as ref_save
    from syzygy_tpu.scene.serialize import scene_to_dict as ref_to_dict

    from syzygy_tpu_torch.app.__main__ import default_mesh_source
    from syzygy_tpu_torch.assets.types import TextureLibrary
    from syzygy_tpu_torch.scene.pack import pack_frame_params
    from syzygy_tpu_torch.scene.serialize import load_scene, save_scene, scene_to_dict

    port, ref = _edited_pair()
    path = str(tmp_path / "scene.json")
    (save_scene if writer == "port" else ref_save)(path, port if writer == "port" else ref)
    material = ref_register(RefLibrary())
    ref_meshes = {"mesh_Cube": ref_cube(material), "mesh_Plane": ref_plane(material)}
    ref_loaded = ref_load(path, ref_meshes.__getitem__)
    port_loaded = load_scene(path, default_mesh_source(TextureLibrary()).__getitem__)
    expected = json.dumps(ref_to_dict(ref_loaded), sort_keys=True)
    assert json.dumps(scene_to_dict(port_loaded), sort_keys=True) == expected

    def without_originals(d):
        return dict(d, geometry=[{k: v for k, v in g.items() if k != "originals"} for g in d["geometry"]])

    # as in the reference, a loaded instance's originals take their angles
    # and scales from its transforms (MeshInstance.set_transforms): the
    # rest of the file comes back unchanged
    assert without_originals(scene_to_dict(port_loaded)) == without_originals(ref_to_dict(ref))
    assert port_loaded.camera_index == 1 and port_loaded.camera.orthographic is True
    a, b = pack_frame_params(port_loaded, 1.5), ref_pack(ref_loaded, 1.5)
    for name in ("translations", "scales", "euler_angles", "cam_position", "bounds_min", "bounds_max"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_scene_file_legacy_camera_key_and_version():
    """The legacy single ``camera`` key loads as camera 0; another version
    is refused."""
    from syzygy_tpu_torch.app.__main__ import default_mesh_source
    from syzygy_tpu_torch.assets.types import TextureLibrary
    from syzygy_tpu_torch.scene.serialize import scene_from_dict, scene_to_dict

    port, _ = _edited_pair()
    data = scene_to_dict(port)
    legacy = dict(data)
    legacy["camera"] = legacy.pop("cameras")[0]
    legacy.pop("camera_index")
    source = default_mesh_source(TextureLibrary()).__getitem__
    scene = scene_from_dict(json.loads(json.dumps(legacy)), source)
    assert len(scene.cameras) == 1 and scene.camera.position == (1.0, -2.0, 3.0)
    with pytest.raises(ValueError):
        scene_from_dict(dict(data, version=2), source)


def test_mesh_source_of_keeps_instances_apart(tmp_path):
    """The flagship bakes each node into a mesh of its own, so pieces of
    one name hold different meshes; ``mesh_source_of`` gives each instance
    its own back, and the loaded scene packs the same geometry."""
    from syzygy_tpu_torch.app.scenes import builtin_scene
    from syzygy_tpu_torch.scene.pack import pack_geometry_host
    from syzygy_tpu_torch.scene.serialize import load_scene, mesh_source_of, save_scene

    scene, library = builtin_scene("flagship")
    path = str(tmp_path / "flagship.json")
    save_scene(path, scene)
    loaded = load_scene(path, mesh_source_of(builtin_scene("flagship")[0]))
    a, b = pack_geometry_host(scene, library), pack_geometry_host(loaded, library)
    for key in ("positions", "triangles", "tri_material"):
        np.testing.assert_array_equal(a[key], b[key])
