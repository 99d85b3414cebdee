"""Shared inputs for the torch-port parity tests, plus tests of the port's
small host pieces (PNG codec, u8 quantize, RenderConfig).

Both packages get identical inputs: scenes are built with each package's
own host code from the same numbers, and for function-level parity the
reference's packed arrays cross over as numpy
(``syzygy_tpu_torch.interop.from_reference``). The JAX side runs as its
own tests run it on the CPU (``conftest.py`` forces the CPU backend;
Pallas runs in interpret mode).
"""

from __future__ import annotations

import dataclasses
import os
import functools

import jax
import numpy as np
import pytest
import torch

import syzygy_tpu_torch  # noqa: F401  (precision pins)
from syzygy_tpu_torch.interop import from_reference

# xdist runs several workers on one host: keep each one's torch pool small
torch.set_num_threads(2)

GOLDEN_W, GOLDEN_H = 256, 128
EYE = (18.0, -16.0, -22.0)
TARGET = (0.0, -6.0, 0.0)


def to_numpy_dict(nt) -> dict:
    """A reference NamedTuple (nested ones included) -> dict of numpy."""
    out = {}
    for key, value in nt._asdict().items():
        if hasattr(value, "_asdict"):
            out[key] = to_numpy_dict(value)
        elif value is not None:
            out[key] = np.asarray(value)
    return out


def rmse(a, b) -> float:
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _camera_eulers():
    from syzygy_tpu.math.geometry import eulers_from_forward

    eye = np.asarray(EYE, np.float32)
    return tuple(np.asarray(eulers_from_forward(np.asarray(TARGET, np.float32) - eye)))


def reference_golden_scene():
    """The reference's golden setup (``tests/test_golden.py:24-39``)."""
    from syzygy_tpu.renderer import RenderConfig
    from syzygy_tpu.scene import default_scene

    scene, lib = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    scene.camera.position = EYE
    scene.camera.euler_angles = _camera_eulers()
    config = RenderConfig(
        width=GOLDEN_W, height=GOLDEN_H, shadow_dim=256, skyview_width=128, skyview_height=64
    )
    return scene, lib, config


def port_golden_scene():
    """The same scene through the port's own host code."""
    from syzygy_tpu_torch.renderer.frame import RenderConfig
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, lib = default_scene()
    scene.sun_animation.time = 0.35
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    scene.camera.position = EYE
    scene.camera.euler_angles = _camera_eulers()
    config = RenderConfig(
        width=GOLDEN_W, height=GOLDEN_H, shadow_dim=256, skyview_width=128, skyview_height=64
    )
    return scene, lib, config


def _dense(scene_cls, transform_cls, library_cls, register, sphere, sun_time):
    scene = scene_cls()
    lib = library_cls()
    mesh = sphere(register(lib), rings=8, segments=16)
    side = 8
    scene.add_mesh_instance(
        mesh,
        "spheres",
        [
            transform_cls.make((8.0 * (i % side) - 4.0 * side, -6.0, 8.0 * (i // side) - 4.0 * side))
            for i in range(side * side)
        ],
    )
    scene.sun_animation.time = sun_time
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    scene.camera.position = EYE
    scene.camera.euler_angles = _camera_eulers()
    return scene, lib


def reference_dense_scene(sun_time=0.35):
    """The dense field of ``bench.py:226-253`` cut to 64 x sphere(8, 16)."""
    from syzygy_tpu.assets import TextureLibrary, register_default_textures, sphere_mesh
    from syzygy_tpu.scene import Scene, TransformHost

    return _dense(Scene, TransformHost, TextureLibrary, register_default_textures, sphere_mesh, sun_time)


def port_dense_scene(sun_time=0.35):
    from syzygy_tpu_torch.assets.defaults import register_default_textures, sphere_mesh
    from syzygy_tpu_torch.assets.types import TextureLibrary
    from syzygy_tpu_torch.scene.scene import Scene, TransformHost

    return _dense(Scene, TransformHost, TextureLibrary, register_default_textures, sphere_mesh, sun_time)


@functools.lru_cache(maxsize=None)
def reference_inputs(which: str):
    """(reference geometry, reference params, port geometry, port params,
    reference config) for ``which`` in {"default", "dense"}; the port's
    tensors are the reference's arrays (interop), on the CPU."""
    from syzygy_tpu.scene import pack_frame_params, pack_geometry

    if which == "default":
        scene, lib, config = reference_golden_scene()
    else:
        scene, lib = reference_dense_scene()
        config = reference_golden_scene()[2]
    geometry = pack_geometry(scene, lib, quad_pack=False, joint_pack=False)
    params = pack_frame_params(scene, GOLDEN_W / GOLDEN_H)
    geo_t, params_t = from_reference(to_numpy_dict(geometry), to_numpy_dict(params), "cpu")
    return geometry, params, geo_t, params_t, config


def port_config(reference_config, **overrides):
    """The port's RenderConfig with the reference config's field values."""
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    fields = {f.name: getattr(reference_config, f.name) for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**(fields | overrides))


# --------------------------------------------------------------------------
# tests of the port's host pieces
# --------------------------------------------------------------------------


def test_png_reader_matches_reference_reader():
    """The stdlib reader decodes the golden exactly as the PIL-backed
    reference reader does."""
    from syzygy_tpu.utils import read_png as reference_read

    from syzygy_tpu_torch.utils.png import read_png

    path = os.path.join(os.path.dirname(__file__), "goldens", "default_scene_256x128.png")
    np.testing.assert_array_equal(read_png(path), reference_read(path))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_roundtrip(tmp_path, channels):
    from syzygy_tpu_torch.utils.png import read_png, write_png

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(37, 53, channels), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = read_png(path)
    np.testing.assert_array_equal(back[..., :channels], img)
    if channels == 3:
        assert (back[..., 3] == 255).all()


def test_quantize_u8_matches_reference():
    """On-device u8 quantize truncates exactly like the reference's
    ``fetch_frame_u8`` (edge values around every half-level)."""
    from syzygy_tpu.runtime import fetch_frame_u8

    from syzygy_tpu_torch.runtime import fetch_frame_u8 as port_fetch

    levels = (np.arange(256, dtype=np.float32) + 0.5) / 255.0
    values = np.concatenate(
        [
            levels,
            np.nextafter(levels, np.float32(0)),
            np.nextafter(levels, np.float32(1)),
            np.array([-1.0, 0.0, 1.0, 2.0, np.float32(1) - np.float32(1e-8)], np.float32),
        ]
    ).astype(np.float32).reshape(-1, 1, 1)
    np.testing.assert_array_equal(port_fetch(torch.from_numpy(values)), fetch_frame_u8(values))


def test_render_config_fields_match_reference():
    """Same field names and defaults as the reference RenderConfig."""
    from syzygy_tpu.renderer import RenderConfig as Reference

    from syzygy_tpu_torch.renderer.frame import RenderConfig

    ref = {f.name: f.default for f in dataclasses.fields(Reference)}
    port = {f.name: f.default for f in dataclasses.fields(RenderConfig)}
    assert port == ref


@pytest.mark.parametrize(
    "field,value",
    [
        ("pcf_bitmask", True), ("pcf_q8", True), ("pcf_window2d", True),
        ("lut_f16", True), ("share_sun_pcf", True), ("raster_unroll", False),
        ("aerial_lut", False), ("fast_sky", True), ("debug_lines", True),
    ],
)
def test_render_config_rejects_unported_modes(field, value):
    from syzygy_tpu_torch.renderer.frame import RenderConfig

    with pytest.raises(NotImplementedError):
        RenderConfig(**{field: value}).check()
    RenderConfig().check()  # the defaults are all supported


def test_mipmaps_not_ported():
    from syzygy_tpu_torch.scene.pack import pack_geometry
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, lib = default_scene()
    with pytest.raises(NotImplementedError):
        pack_geometry(scene, lib, "cpu", mipmaps=True)


def test_reference_runs_on_cpu():
    """The parity tests hold the port against the CPU reference."""
    assert jax.default_backend() == "cpu"
