"""The port's host scene API against the JAX package's on the same inputs:
the fly camera and its matrices, multiple cameras, instance transform
tables and material overrides, ``make_spot``, the atmosphere's host
helpers, the texture library's lookup API, and ``utils.metrics``/
``utils.log``.

Tolerances: bitwise where the arithmetic is the reference's host
arithmetic (fly input over a 60-step script, the camera matrices built
from glibc's ``sinf``/``cosf``, numpy tables); 1e-6 relative + 1e-6
absolute where the port evaluates a matrix with torch's trigonometry
(``packed``, ``make_spot``, the atmosphere's packed and baked forms).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 1e-6


def _close(port, ref):
    np.testing.assert_allclose(port.cpu().numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


def _input_script(n=60, seed=7):
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        keys = frozenset(k for k in "wasdqe" if rng.random() < 0.4)
        cursor = tuple(int(x) for x in rng.integers(-40, 40, 2)) if rng.random() < 0.5 else (0.0, 0.0)
        script.append((float(rng.uniform(0.0, 0.2)), cursor, keys))
    return script


@pytest.mark.parametrize(
    "start",
    [
        dict(position=(0.0, -10.0, -13.0), euler_angles=(0.0, 0.0, 0.0)),
        dict(position=(18.0, -16.0, -22.0), euler_angles=(0.4, 0.3, -0.7)),
    ],
    ids=["default", "rolled"],
)
def test_handle_input_bitwise_over_60_steps(start):
    """``Scene.handle_input`` (WASDQE + mouse look, pitch clamped, up not
    rotated) leaves the camera bitwise where the reference's leaves it
    after every step of a 60-step seeded script, a rolled camera
    included."""
    from syzygy_tpu.scene import Scene as RefScene
    from syzygy_tpu.scene.camera import Camera as RefCamera

    from syzygy_tpu_torch.scene.camera import Camera
    from syzygy_tpu_torch.scene.scene import Scene

    ref, port = RefScene(cameras=[RefCamera(**start)]), Scene(cameras=[Camera(**start)])
    ref.camera_speed = port.camera_speed = 13.5
    for i, (dt, cursor, keys) in enumerate(_input_script()):
        ref.handle_input(dt, cursor, keys)
        port.handle_input(dt, cursor, keys)
        assert port.camera.position == ref.camera.position, i
        assert port.camera.euler_angles == ref.camera.euler_angles, i
    assert abs(port.camera.euler_angles[0]) <= np.pi / 2


@pytest.mark.parametrize("orthographic", [False, True])
def test_camera_matrices(orthographic):
    """``rotation``/``transform``/``view`` bitwise (the reference's host
    trigonometry), ``projection`` bitwise, ``packed`` to 1e-6, in both
    projections; the tensors land on the device asked for."""
    from syzygy_tpu.scene.camera import Camera as RefCamera

    from syzygy_tpu_torch.scene.camera import Camera

    kw = dict(position=(3.0, -7.5, 11.0), euler_angles=(0.31, -0.2, 2.4), fov_degrees=55.0,
              orthographic=orthographic)
    ref, port = RefCamera(**kw), Camera(**kw)
    for name in ("rotation", "transform", "view"):
        out = getattr(port, name)(CPU)
        assert out.dtype == torch.float32 and out.device == CPU
        np.testing.assert_array_equal(out.numpy(), np.asarray(getattr(ref, name)()))
    np.testing.assert_array_equal(port.projection(1.75, CPU).numpy(), np.asarray(ref.projection(1.75)))
    for p, r in zip(port.packed(1.75, CPU), ref.packed(1.75)):
        _close(p, r)


def test_multiple_cameras_and_the_active_one():
    """``cameras``/``camera_index``/``add_camera`` as the reference's:
    the packed frame reads the active camera, edits go to it alone, and
    the 20-camera capacity raises."""
    from syzygy_tpu.scene import default_scene as ref_default
    from syzygy_tpu.scene import pack_frame_params as ref_pack
    from syzygy_tpu.scene.camera import Camera as RefCamera

    from syzygy_tpu_torch.scene.camera import Camera
    from syzygy_tpu_torch.scene.pack import pack_frame_params
    from syzygy_tpu_torch.scene.scene import Scene, default_scene

    port, _ = default_scene()
    ref, _ = ref_default()
    assert port.add_camera(Camera(position=(30.0, -5.0, 0.0))) == ref.add_camera(RefCamera(position=(30.0, -5.0, 0.0))) == 1
    for scene in (port, ref):
        scene.camera_index = 1
        scene.camera.euler_angles = (0.2, 0.0, -1.1)
    a, b = pack_frame_params(port, 16 / 9), ref_pack(ref, 16 / 9)
    for name in ("cam_position", "cam_euler_angles", "cam_fov_degrees"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    assert port.cameras[0].position == ref.cameras[0].position != (30.0, -5.0, 0.0)
    for _ in range(Scene.MAX_CAMERAS - len(port.cameras)):
        port.add_camera()
    with pytest.raises(ValueError):
        port.add_camera()
    assert Scene.MAX_CAMERAS == type(ref).MAX_CAMERAS == 20


def test_instance_tables_match_the_reference():
    """Transforms, originals and model matrices of every instance bitwise
    the reference's, including the reference's reset defaults: an
    original's scale is the scale before the mesh normalization of
    ``add_mesh_instance`` (the floor: (20, 1, 20) against (2000, 100,
    2000)). ``set_transforms`` takes only the originals' translations."""
    from syzygy_tpu.scene import default_scene as ref_default
    from syzygy_tpu.scene.scene import TransformHost as RefTransform

    from syzygy_tpu_torch.scene.scene import TransformHost, default_scene

    port, _ = default_scene()
    ref, _ = ref_default()
    for p, r in zip(port.geometry, ref.geometry):
        for field in ("translations", "eulers", "scales", "orig_translations"):
            np.testing.assert_array_equal(getattr(p, field), getattr(r, field))
        for rows in ("transforms", "originals"):
            for tp, tr in zip(getattr(p, rows), getattr(r, rows)):
                for f in ("translation", "euler_angles", "scale"):
                    np.testing.assert_array_equal(getattr(tp, f), getattr(tr, f))
        np.testing.assert_array_equal(p.model_matrices(), r.model_matrices())
    np.testing.assert_array_equal(port.geometry[2].originals[0].scale, [20.0, 1.0, 20.0])
    np.testing.assert_array_equal(port.geometry[2].transforms[0].scale, [2000.0, 100.0, 2000.0])

    new = [((1.0, 2.0, 3.0), (0.1, 0.2, 0.3), (2.0, 2.0, 2.0))]
    orig = [((9.0, 9.0, 9.0), (1.0, 1.0, 1.0), (5.0, 5.0, 5.0))]
    port.geometry[0].set_transforms([TransformHost.make(*t) for t in new], [TransformHost.make(*t) for t in orig])
    ref.geometry[0].set_transforms([RefTransform.make(*t) for t in new], [RefTransform.make(*t) for t in orig])
    p, r = port.geometry[0], ref.geometry[0]
    for f in ("translation", "euler_angles", "scale"):
        np.testing.assert_array_equal(getattr(p.originals[0], f), getattr(r.originals[0], f))
    np.testing.assert_array_equal(p.originals[0].scale, [2.0, 2.0, 2.0])
    p.transforms[0].translation[:] = (4.0, 5.0, 6.0)  # rows are views into the SoA block
    np.testing.assert_array_equal(p.translations[0], [4.0, 5.0, 6.0])


def test_material_override_in_the_packer():
    """``set_material_override`` replaces one surface's material in
    ``pack_geometry`` and in ``scene_uses_metallic``, as the reference's
    packer does (``pack.py:259``, ``:378``)."""
    from syzygy_tpu.assets import MaterialData as RefMaterial
    from syzygy_tpu.assets import TextureLibrary as RefLibrary
    from syzygy_tpu.assets import cube_mesh as ref_cube
    from syzygy_tpu.assets import register_default_textures as ref_register
    from syzygy_tpu.scene import Scene as RefScene
    from syzygy_tpu.scene import TransformHost as RefTransform
    from syzygy_tpu.scene import pack_geometry as ref_pack_geometry
    from syzygy_tpu.scene import scene_uses_metallic as ref_metallic

    from syzygy_tpu_torch.assets.defaults import cube_mesh, register_default_textures
    from syzygy_tpu_torch.assets.types import MaterialData, TextureLibrary
    from syzygy_tpu_torch.scene.pack import pack_geometry_host, scene_uses_metallic
    from syzygy_tpu_torch.scene.scene import Scene, TransformHost

    metal = np.zeros((4, 4, 4), np.float32)
    metal[..., 2] = 0.9
    out = {}
    for name, Lib, register, cube, Sc, Tr, Mat in (
        ("port", TextureLibrary, register_default_textures, cube_mesh, Scene, TransformHost, MaterialData),
        ("ref", RefLibrary, ref_register, ref_cube, RefScene, RefTransform, RefMaterial),
    ):
        lib = Lib()
        mat = register(lib)
        metal_id = lib.register("metal_orm", metal)
        scene = Sc()
        inst = scene.add_mesh_instance(cube(mat), "Cube", [Tr.make((0, -4, 0))])
        before = scene_uses_metallic(scene, lib) if name == "port" else ref_metallic(scene, lib)
        inst.set_material_override(0, Mat(color=mat.color, normal=mat.normal, orm=metal_id))
        if name == "port":
            out[name] = (before, scene_uses_metallic(scene, lib), pack_geometry_host(scene, lib)["materials"])
        else:
            out[name] = (before, ref_metallic(scene, lib), np.asarray(ref_pack_geometry(scene, lib).materials))
    assert out["port"][:2] == out["ref"][:2] == (False, True)
    np.testing.assert_array_equal(out["port"][2], out["ref"][2])


def test_make_spot():
    """``make_spot`` of one spotlight on a device, to 1e-6 of the
    reference's."""
    from syzygy_tpu.scene.lights import SpotlightParams as RefParams
    from syzygy_tpu.scene.lights import make_spot as ref_make_spot

    from syzygy_tpu_torch.scene.lights import SpotlightParams, make_spot

    kw = dict(color=(1.0, 0.5, 0.25, 1.0), strength=800.0, falloff_factor=2.0, falloff_distance=3.0,
              vertical_fov_degrees=40.0, horizontal_scale=1.5, euler_angles=(0.3, 0.1, -0.8),
              position=(4.0, -9.0, 2.0), near=0.2, far=500.0)
    port, ref = make_spot(SpotlightParams(**kw), CPU), ref_make_spot(RefParams(**kw))
    for p, r in zip(port, ref):
        _close(p, r)


@pytest.mark.parametrize("sun_euler", [(1.0, 0.0, 0.0), (0.2, 0.1, 2.0), (-0.05, 0.0, 0.5)], ids=["day", "low", "night"])
def test_atmosphere_host_helpers(sun_euler):
    """``direction_to_sun``, ``packed`` and ``baked`` (sun + moon lights
    over a scene's bounds) to 1e-6 of the reference's; ``baked``'s lights
    are rows of the frame's ``bake_directional`` on the same inputs."""
    from syzygy_tpu.math.geometry import AABB as RefAABB
    from syzygy_tpu.scene.atmosphere import Atmosphere as RefAtmosphere

    from syzygy_tpu_torch.math.geometry import AABB
    from syzygy_tpu_torch.scene.atmosphere import Atmosphere, atmosphere_raw, bake_directional

    port, ref = Atmosphere(sun_euler_angles=sun_euler), RefAtmosphere(sun_euler_angles=sun_euler)
    _close(port.direction_to_sun(CPU), ref.direction_to_sun())
    for p, r in zip(port.packed(CPU), ref.packed()):
        _close(p, r)
    lo, hi = np.array([-20.0, -9.0, -20.0], np.float32), np.array([20.0, 1.0, 20.0], np.float32)
    center, half = (lo + hi) * 0.5, (hi - lo) * 0.5
    baked = port.baked(AABB(torch.from_numpy(center), torch.from_numpy(half)))
    ref_baked = ref.baked(RefAABB(center, half))
    for light, ref_light in ((baked.sunlight, ref_baked.sunlight), (baked.moonlight, ref_baked.moonlight)):
        for p, r in zip(light, ref_light):
            _close(p, r)
    raw = atmosphere_raw(port)
    stacked = bake_directional(
        type(raw)(*[torch.from_numpy(np.asarray(x)) for x in raw]), torch.from_numpy(lo), torch.from_numpy(hi)
    )
    for row, light in enumerate((baked.sunlight, baked.moonlight)):
        for p, s in zip(light, stacked):
            torch.testing.assert_close(p, s[row], rtol=TOL, atol=TOL)


def test_texture_library_lookup_api():
    """``lookup``/``names``/``is_srgb`` and ``register(replace=)`` as the
    reference's: a repeated name keeps its texels unless ``replace``,
    which re-reads texels and sRGB flag in place."""
    from syzygy_tpu.assets import TextureLibrary as RefLibrary

    from syzygy_tpu_torch.assets.types import TextureLibrary

    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (4, 6, 4), dtype=np.uint8)
    b = rng.integers(0, 256, (4, 6, 4), dtype=np.uint8)
    libs = (TextureLibrary(), RefLibrary())
    for lib in libs:
        assert lib.register("a", a, srgb=True) == 0
        assert lib.register("b", a) == 1
        assert lib.register("a", b) == 0  # kept
        assert lib.lookup("nope") is None
    port, ref = libs
    assert port.names() == ref.names() == ["a", "b"]
    np.testing.assert_array_equal(port.get(0), ref.get(0))
    for lib in libs:
        assert lib.register("a", b, srgb=False, replace=True) == 0
    assert port.is_srgb(0) is ref.is_srgb(0) is False
    np.testing.assert_array_equal(port.get(0), ref.get(0))
    np.testing.assert_array_equal(port.get(0), b.astype(np.float32) / 255.0)


@pytest.mark.parametrize("n", [0, 7, 500, 523])
def test_ring_buffer_reports(n):
    """``RingBuffer``'s report, history (oldest first) and current value
    equal the reference's over seeded samples, across the 500-slot wrap."""
    from syzygy_tpu.utils import RingBuffer as RefRing

    from syzygy_tpu_torch.utils.metrics import RingBuffer

    rng = np.random.default_rng(n)
    port, ref = RingBuffer(), RefRing()
    for value in rng.uniform(1.0, 240.0, n):
        port.write(float(value))
        ref.write(float(value))
    assert port.report() == ref.report()
    assert port.history() == ref.history()
    assert port.average() == ref.average()
    if n:
        assert port.current() == ref.current()
        assert len(port.history()) == min(n, RingBuffer.CAPACITY)


def test_tick_timing_and_logging(tmp_path):
    """``TickTiming`` has the reference's fields; ``init_logging`` sets up
    the ``syzygy`` logger once with a console and a flushed file sink."""
    from syzygy_tpu.utils import TickTiming as RefTiming

    from syzygy_tpu_torch.utils.log import init_logging
    from syzygy_tpu_torch.utils.metrics import TickTiming

    assert dataclasses.asdict(TickTiming()) == dataclasses.asdict(RefTiming())
    logger = logging.getLogger("syzygy")
    saved, level = logger.handlers[:], logger.level
    logger.handlers = []
    try:
        path = tmp_path / "Syzygy.log"
        assert init_logging(logging.DEBUG, str(path)) is logger
        assert len(logger.handlers) == 2
        logger.debug("hello from the port")
        assert "hello from the port" in path.read_text()
        assert init_logging(log_file=str(path)) is logger and len(logger.handlers) == 2
    finally:
        for h in logger.handlers:
            h.close()
        logger.handlers, logger.level = saved, level
