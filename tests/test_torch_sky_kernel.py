"""The CUDA sky camera pass vs its plain torch version, without JAX.

This file imports only torch and the port, so it also runs on a GPU host
that has no JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_sky_kernel.py

The ``cuda``-marked tests hold ``csrc/sky.cu`` bitwise to
``sky_camera_pass_lut_plain`` on the card, the pass's inputs recorded as
a 1920x1080 frame (1088 padded rows) calls it: the editor's default scene
(no metallic bounce) and the chess flagship (the bounce) at the cells'
settings (8192^2 maps, f32 taps, q8 sky-view); a given sun PCF; the f16
and f32 sky-view LUTs and ``lut_f16``; f16 and q8 taps at 2048 and 256
texels; the per-pixel segment in place of the t_seg rows; a row block at
a non-zero origin; a supersampled extent; an all-background and an
all-geometry target. Inputs that need a gradient get the plain version's;
a captured LUT frame holds one sky launch, a quirk-exact one none. They
skip without a GPU. The unmarked ones check on the CPU, on a 256x128
chess frame, the frame table the kernel reads (bitwise the plain
version's values), which inputs launch the kernel and with which tap
format, that CPU inputs take the plain version, that the card's gradient
is the plain version's, and that importing the module builds nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest
import torch

from syzygy_tpu_torch.kernels import build, plain_gradient, sky
from syzygy_tpu_torch.kernels.build import LAUNCHES
from syzygy_tpu_torch.kernels.lighting import PCF_WINDOW_MAX_DIM, _TO_TEX_COORD, _normalize
from syzygy_tpu_torch.kernels.sky import sky_camera_pass, sky_camera_pass_lut_plain, sky_table
from syzygy_tpu_torch.math.geometry import matmul4, vec_norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32


def _pass_inputs(device, scene_name: str, row0: int = 0, **overrides):
    """The sky pass's inputs as a frame's rows ``[row0, ...)`` call it
    (``renderer/frame.py::_sky``): (args, keywords) of
    ``sky_camera_pass``, the sun's map cloned out of the stack, and the
    config. The cells' settings by default: 1920x1080, 8192^2 maps, the
    bounce as the scene uses it."""
    from syzygy_tpu_torch.bench import chess_scene, default_scene_animated
    from syzygy_tpu_torch.renderer import frame
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_linear
    from syzygy_tpu_torch.scene.pack import (
        pack_frame_params,
        pack_geometry,
        scene_uses_metallic,
        upload_frame_params,
    )

    scene, library = default_scene_animated() if scene_name == "editor" else chess_scene()
    config = RenderConfig(**(
        dict(width=1920, height=1080, shadow_dim=8192, metallic_reflection=scene_uses_metallic(scene, library))
        | overrides
    ))
    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    calls = []

    def spy(*args, **kwargs):
        calls.append((args[:8] + (args[8].clone(),) + args[9:], kwargs))
        return sky.sky_camera_pass(*args, **kwargs)

    real = frame.sky_camera_pass
    frame.sky_camera_pass = spy
    try:
        with torch.no_grad():
            render_frame_linear(geometry, params, config, row0, config.padded_height - row0)
    finally:
        frame.sky_camera_pass = real
    args, kwargs = calls[0]
    return list(args), dict(kwargs), config


@pytest.fixture(scope="module")
def small():
    """The pass's inputs of a 256x128 chess frame on the CPU (256^2 maps,
    a 256x128 sky-view LUT, the bounce on)."""
    return _pass_inputs(
        torch.device("cpu"), "chess", width=256, height=128, shadow_dim=256, skyview_width=256, skyview_height=128,
    )


def test_sky_table_is_the_plain_values(small):
    """Every entry of ``sky_table`` is, bitwise, what the plain version
    computes: the camera's matrices and its position in sky space, the
    radii, the sun's direction, light projection, normalized light
    direction and norm, its angular radius and spectrum, its shadow frame
    and the aerial LUT's ``t_sun0``."""
    args, kw, _ = small
    camera, atmo, sun = args[3], args[4], args[7]
    table = sky_table(camera, atmo, sun, kw["aerial"])
    assert table.shape == (sky.SKY_TABLE,) and table.dtype == F32
    position, _, _, _ = sky.camera_rays(camera, atmo, 1, 1, (1, 1))
    frame = matmul4(torch.tensor(_TO_TEX_COORD, dtype=F32), matmul4(sun.projection, sun.view))
    s = atmo.incident_direction_sun
    want = [
        camera.inverse_projection.reshape(16), camera.rotation.reshape(16), position,
        atmo.planet_radius_mm.reshape(1), atmo.atmosphere_radius_mm.reshape(1), s,
        -torch.stack([s[0], s[2]]) / torch.clamp(vec_norm(-torch.stack([s[0], s[2]])), min=1e-12),
        _normalize(-s), vec_norm(-s).reshape(1), atmo.sun_angular_radius.reshape(1),
        atmo.sun_intensity_spectrum.reshape(3), frame.reshape(16), kw["aerial"].t_sun0,
    ]
    assert torch.equal(table, torch.cat(want))


def _cuda_stand_in(shape):
    """The depth as the dispatch sees it on a card: a device and a shape,
    no storage."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=tuple(shape))


def test_dispatch_rule(monkeypatch, small):
    """A LUT pass on a card launches the kernel, whatever the flags: f16
    taps for ``pcf_f16`` and q8 taps for ``pcf_q8`` at up to
    ``PCF_WINDOW_MAX_DIM`` texels, f32 taps above it, no q8 tables where
    the sun's PCF is given, the bounce as asked; inputs that need a
    gradient too. CPU inputs take the plain version (on the card the
    quirk-exact formulation launches none:
    ``test_captured_frame_holds_its_sky_launch``)."""
    launched = []

    def fake_launch(*a):
        launched.append((a[8].shape[-1], a[15], a[16], a[14]))
        return torch.zeros(tuple(a[1].shape) + (3,))

    monkeypatch.setattr(sky, "_launch_kernel", fake_launch)
    args, kw, _ = small
    depth = args[1]
    card = [args[0], _cuda_stand_in(depth.shape), *args[2:]]
    big = card[:8] + [_cuda_stand_in((2 * PCF_WINDOW_MAX_DIM,) * 2)]
    for inputs, flags, want in [
        (card, {}, (256, False, False, True)),
        (card, dict(pcf_f16=True), (256, True, False, True)),
        (card, dict(pcf_q8=True), (256, False, True, True)),
        (card, dict(pcf_f16=True, pcf_q8=True, metallic_reflection=False), (256, True, True, False)),
        (card, dict(pcf_q8=True, sun_shadow=torch.ones(depth.shape)), (256, False, False, True)),
        (big, dict(pcf_f16=True, pcf_q8=True), (2 * PCF_WINDOW_MAX_DIM, False, False, True)),
    ]:
        sky_camera_pass(*inputs, **(kw | dict(pcf_f16=False, pcf_q8=False) | flags))
        assert launched.pop() == want, flags
    color = args[0].clone().requires_grad_(True)
    lit = sky_camera_pass(color, *card[1:], **kw)
    assert launched.pop()[0] == 256 and lit.grad_fn is not None
    sky_camera_pass(*args, **kw)
    assert not launched


def test_cpu_and_grad_inputs_take_the_plain_version(monkeypatch, small):
    """On the CPU, with and without inputs that require grad, the LUT pass
    is ``sky_camera_pass_lut_plain`` bitwise and launches nothing (the
    kernel's library is never loaded)."""

    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", refuse)
    args, kw, _ = small
    before = LAUNCHES["sky"]
    settings = (kw["draw_extent"], kw["aerial_t_max"], kw["metallic_reflection"], kw["pcf_f16"], kw["pcf_q8"],
                kw["row_origin"])
    plain = sky_camera_pass_lut_plain(*args, kw["aerial"], kw["tseg_rows"], kw["sun_shadow"], *settings)
    got = sky_camera_pass(*args, **kw)
    assert torch.equal(got, plain) and got.abs().sum() > 0
    color = args[0].clone().requires_grad_(True)
    sky_camera_pass(color, *args[1:], **kw).sum().backward()
    assert color.grad is not None and color.grad.abs().sum() > 0
    assert LAUNCHES["sky"] == before


def test_card_gradient_is_the_plain_versions(small):
    """Where inputs need a gradient on the card, the kernel's colour
    carries the plain version's gradient: checked on the CPU with the
    plain version standing in for the kernel's forward, against autograd
    through the plain version itself, for the lit colour, the G-buffer's
    diffuse plane and the sun's spectrum."""
    args, kw, _ = small
    color = args[0].clone().requires_grad_(True)
    diffuse = args[2].diffuse.clone().requires_grad_(True)
    spectrum = args[4].sun_intensity_spectrum.clone().requires_grad_(True)
    every = (color, args[1], args[2]._replace(diffuse=diffuse), args[3],
             args[4]._replace(sun_intensity_spectrum=spectrum), *args[5:9], kw["aerial"], kw["tseg_rows"], None)
    settings = (kw["draw_extent"], kw["aerial_t_max"], kw["metallic_reflection"], kw["pcf_f16"], kw["pcf_q8"],
                kw["row_origin"])

    def plain(*a):
        return sky_camera_pass_lut_plain(*a, *settings)

    def kernel():
        with torch.no_grad():
            return plain(*every)

    needs = plain_gradient.grad_leaves(every)
    assert [id(t) for t in needs] == [id(color), id(diffuse), id(spectrum)]
    out = plain_gradient.PlainGradient.apply(kernel, plain, every, *needs)
    weights = torch.rand(out.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad((out * weights).sum(), needs)
    want = torch.autograd.grad((plain(*every) * weights).sum(), needs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(g.abs().sum() > 0 for g in got)


def test_import_builds_nothing():
    """Importing the sky module loads no CUDA library and starts no
    compiler."""
    code = (
        "import ctypes\n"
        "loaded = []\n"
        "real = ctypes.CDLL.__init__\n"
        "def spy(self, name, *a, **k):\n"
        "    loaded.append(name)\n"
        "    real(self, name, *a, **k)\n"
        "ctypes.CDLL.__init__ = spy\n"
        "import subprocess\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError('a compiler was started')\n"
        "subprocess.Popen = refuse\n"
        "import syzygy_tpu_torch.kernels.sky as sky\n"
        "from syzygy_tpu_torch.kernels import build\n"
        "bad = [n for n in loaded if n and ('syzygy' in str(n) or 'cuda' in str(n).lower())]\n"
        "assert not bad and not build._loaded, (bad, build._loaded)\n"
        "assert not build.LAUNCHES\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------------------------
# on the card: the kernel bitwise its plain version
# --------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the sky kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _both(args, kw):
    """The kernel's and the plain version's colour of the same inputs, and
    the kernel's launches."""
    settings = (kw["draw_extent"], kw["aerial_t_max"], kw["metallic_reflection"], kw["pcf_f16"], kw["pcf_q8"],
                kw["row_origin"])
    with torch.no_grad():
        before = LAUNCHES["sky"]
        kernel = sky_camera_pass(*args, **kw)
        launched = LAUNCHES["sky"] - before
        plain = sky_camera_pass_lut_plain(*args, kw["aerial"], kw["tseg_rows"], kw["sun_shadow"], *settings)
    torch.cuda.synchronize()
    return kernel, plain, launched


def _assert_bitwise(kernel, plain):
    assert kernel.shape == plain.shape and kernel.dtype == plain.dtype
    differ = (kernel.view(torch.int32) != plain.view(torch.int32)).any(dim=-1)
    assert not differ.any(), (
        f"{int(differ.sum())} pixels differ, first at {differ.nonzero()[:4].tolist()}: "
        f"{kernel[differ][:4].tolist()} vs {plain[differ][:4].tolist()}"
    )


def _check(device, scene_name, row0=0, **overrides):
    args, kw, config = _pass_inputs(device, scene_name, row0, **overrides)
    kernel, plain, launched = _both(args, kw)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and (kernel != 0).any()
    return args, kw, config, kernel


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["editor", "chess"])
def test_kernel_matches_plain_scene(cuda, scene):
    """The cells' settings: 1920x1088, the sun's 8192^2 map in f32 taps,
    the q8 sky-view LUT and the t_seg rows; the editor without the bounce,
    the chess flagship with it; one launch."""
    args, kw, _, _ = _check(cuda, scene)
    assert kw["metallic_reflection"] == (scene == "chess") and args[1].shape == (1088, 1920)


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [
    dict(share_sun_pcf=True),
    dict(skyview_q8=False),
    dict(skyview_q8=False, skyview_f16=False),
    dict(lut_f16=True),
    dict(skyview_tseg=False),
], ids=["shared_sun_pcf", "skyview_f16", "skyview_f32", "lut_f16", "segment_per_pixel"])
def test_kernel_matches_plain_storage(cuda, overrides):
    """A given sun PCF, the f16 and f32 sky-view LUTs, f16 sampling copies
    of the transmittance LUT and the aerial volume, and the ground's
    per-pixel segment in place of the t_seg rows, on the chess flagship."""
    _check(cuda, "chess", **overrides)


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [256, 2048])
@pytest.mark.parametrize("taps", ["f16", "q8"])
def test_kernel_matches_plain_small_maps(cuda, dim, taps):
    """Maps of at most 2048 texels: the sun's taps rounded to f16, or
    decoded from its q8 segments."""
    _check(cuda, "editor" if dim == 256 else "chess", shadow_dim=dim, pcf_q8=taps == "q8")


@pytest.mark.cuda
def test_kernel_row_block(cuda):
    """Rows [512, 1088) as a block at a non-zero origin: bitwise the plain
    version's block and the whole frame's rows."""
    _, _, _, block = _check(cuda, "chess", row0=512)
    _, _, _, whole = _check(cuda, "chess")
    assert block.shape[0] == 576
    _assert_bitwise(block, whole[512:])


@pytest.mark.cuda
def test_kernel_supersampled_extent(cuda):
    """``supersample=2`` at 960x540: the rays over a 1920x1080 draw extent
    inside a 1920x1088 padded target."""
    args, kw, _, _ = _check(cuda, "chess", width=960, height=540, supersample=2)
    assert kw["draw_extent"] == (1920, 1080) and args[1].shape == (1088, 1920)


@pytest.mark.cuda
@pytest.mark.parametrize("target", ["background", "geometry"])
def test_kernel_all_one_branch(cuda, target):
    """A target of environment pixels only (depth 0), and one of geometry
    pixels only (every depth set, every surface above the ground), at
    256x128 with the bounce."""
    args, kw, _ = _pass_inputs(cuda, "chess", width=256, height=128, shadow_dim=256)
    depth, gbuffer = args[1], args[2]
    if target == "background":
        args[1] = torch.zeros_like(depth)
    else:
        args[1] = torch.where(depth == 0, 0.5, depth)
        position = gbuffer.world_position
        args[2] = gbuffer._replace(world_position=torch.cat([
            position[..., :1], -position[..., 1:2].abs(), position[..., 2:]], dim=-1))
    kernel, plain, launched = _both(args, kw)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and (kernel != 0).any()


@pytest.mark.cuda
def test_kernel_gradient_is_the_plain_versions(cuda):
    """Inputs that need a gradient on the card: the kernel's colour,
    bitwise, with the plain version's gradient, bitwise."""
    args, kw, _ = _pass_inputs(cuda, "chess", width=256, height=128, shadow_dim=256)
    color = args[0].clone().requires_grad_(True)
    diffuse = args[2].diffuse.clone().requires_grad_(True)
    args = [color, args[1], args[2]._replace(diffuse=diffuse), *args[3:]]
    settings = (kw["draw_extent"], kw["aerial_t_max"], kw["metallic_reflection"], kw["pcf_f16"], kw["pcf_q8"],
                kw["row_origin"])
    before = LAUNCHES["sky"]
    out = sky_camera_pass(*args, **kw)
    assert LAUNCHES["sky"] == before + 1
    plain = sky_camera_pass_lut_plain(*args, kw["aerial"], kw["tseg_rows"], kw["sun_shadow"], *settings)
    _assert_bitwise(out.detach(), plain.detach())
    weights = torch.rand(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    got = torch.autograd.grad((out * weights).sum(), (color, diffuse))
    want = torch.autograd.grad((plain * weights).sum(), (color, diffuse))
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("aerial_lut", [True, False])
def test_captured_frame_holds_its_sky_launch(cuda, aerial_lut):
    """A replayed LUT frame launches the sky kernel once; a quirk-exact
    frame (``aerial_lut=False``) never does."""
    from syzygy_tpu_torch.bench import chess_scene
    from syzygy_tpu_torch.renderer.frame import RenderConfig, captured_frames, render_frame_packed
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    scene, library = chess_scene()
    config = RenderConfig(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64,
                          aerial_lut=aerial_lut)
    host = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(host)
    geometry = pack_geometry(scene, library, cuda)
    row = flatten_frame_params(host, spec)
    before = LAUNCHES["sky"]
    render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    render_frame_packed(geometry, row, spec, config)
    render_frame_packed(geometry, row, spec, config)
    torch.cuda.synchronize()
    launches = 1 if aerial_lut else 0
    assert captured_frames()[-1]["launches"]["sky"] == launches
    assert LAUNCHES["sky"] == before + 3 * launches
