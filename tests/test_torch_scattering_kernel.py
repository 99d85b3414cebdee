"""The CUDA in-scattering integral vs its plain torch version, without JAX.

This file imports only torch and the port, so it also runs on a GPU host
that has no JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_scattering_kernel.py

The ``cuda``-marked tests hold ``csrc/scattering.cu`` bitwise to
``luminance_scattering_integral_plain`` and
``_scattering_integral_components_plain`` on the card: every integral a
1920x1080 frame computes, recorded as the frame calls it (the sky-view
rows in components form and the 16x32x32 aerial froxels of the editor's
default scene; the sky-view rows, the per-pixel integral from the shared
eye and the metallic bounce's from every surface of the chess flagship's
quirk-exact frame), and seeded rays near the ground (grazing,
below-horizon, distance 0, steps under 1e-7) with a shared and a per-ray
origin, in both forms; each call is one launch over all its rays. Inputs
that need a gradient get the plain version's; a captured frame holds one
launch per integral. They skip without a GPU. The unmarked ones check on
the CPU the atmosphere table the kernel reads, how the rays are passed,
the argument checks, which inputs launch the kernel, that CPU inputs take
the plain version, that the card's gradient is the plain version's, and
that importing the module builds nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.kernels import atmosphere, build, plain_gradient
from syzygy_tpu_torch.kernels.build import LAUNCHES
from syzygy_tpu_torch.kernels.atmosphere import (
    _rays,
    _scattering_integral_components,
    _scattering_integral_components_plain,
    compute_transmittance_lut,
    luminance_scattering_integral,
    luminance_scattering_integral_plain,
    raycast_atmosphere,
    scattering_table,
)
from syzygy_tpu_torch.math.geometry import vec_norm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32
FORMS = {
    "luminance": (luminance_scattering_integral, luminance_scattering_integral_plain),
    "components": (_scattering_integral_components, _scattering_integral_components_plain),
}


def _atmosphere(device, time: float = 0.3):
    """The default scene's packed atmosphere with its sun at ``time``."""
    from syzygy_tpu_torch.scene.scene import default_scene

    scene, _ = default_scene()
    scene.sun_animation.time = time
    scene.sun_animation.frozen = True
    scene.tick(0.0)
    return scene.atmosphere.packed(device)


def _edge_rays(atmo, n: int, seed: int):
    """``n`` seeded rays near the ground, (origin (n, 3), direction (n, 3),
    distance (n,)) as CPU f32: origins 1 m to 30 km up; a quarter of the
    directions anywhere, a quarter grazing the horizon (the tangent plane
    tilted by the horizon's dip plus or minus 1e-6 to 1e-3 rad), a quarter
    below it, a quarter above it; distances to the atmosphere's edge or the
    ground, with one ray in eight at distance 0 and one in eight under 32e-7
    Mm (steps under 1e-7)."""
    rng = np.random.default_rng(seed)
    radius = float(atmo.planet_radius_mm.cpu())
    alt = np.exp(rng.uniform(np.log(1e-6), np.log(0.03), n))
    up = rng.normal(size=(n, 3)) * np.array([1e-3, 1.0, 1e-3])
    up /= np.linalg.norm(up, axis=-1, keepdims=True)
    origin = up * (radius + alt)[:, None]
    tangent = np.cross(up, rng.normal(size=(n, 3)))
    tangent /= np.linalg.norm(tangent, axis=-1, keepdims=True)
    dip = np.arccos(radius / (radius + alt))
    kind = np.arange(n) % 4
    tilt = np.where(
        kind == 1, -dip + rng.choice([-1.0, 1.0], n) * np.exp(rng.uniform(np.log(1e-6), np.log(1e-3), n)),
        np.where(kind == 2, -rng.uniform(0.0, np.pi / 2, n), rng.uniform(0.0, np.pi / 2, n)),
    )
    direction = np.cos(tilt)[:, None] * tangent + np.sin(tilt)[:, None] * up
    anywhere = rng.normal(size=(n, 3))
    direction = np.where((kind == 0)[:, None], anywhere / np.linalg.norm(anywhere, axis=-1, keepdims=True), direction)
    origin_t = torch.from_numpy(origin.astype(np.float32))
    direction_t = torch.from_numpy(direction.astype(np.float32))
    cpu = type(atmo)(*[f.cpu() for f in atmo])
    distance = raycast_atmosphere(cpu, origin_t, direction_t)
    which = np.arange(n) % 8
    distance = torch.where(torch.from_numpy(which == 3), 0.0, distance)
    tiny = torch.from_numpy(rng.uniform(0.0, 32e-7, n).astype(np.float32))
    distance = torch.where(torch.from_numpy(which == 5), tiny, distance)
    return origin_t, direction_t, distance


def _small_case(seed: int = 1, n: int = 64):
    """An integral's positional inputs on the CPU: the default scene's
    atmosphere, a 64x16 transmittance LUT and :func:`_edge_rays`."""
    atmo = _atmosphere("cpu")
    lut = compute_transmittance_lut(atmo, 64, 16)
    return [atmo, lut, *_edge_rays(atmo, n, seed)]


def test_scattering_table_is_the_plain_values():
    """The table holds the atmosphere's values in the kernel's order and
    the sun's angular radius's sine and cosine and the sun direction's norm
    as the plain version computes them, bitwise."""
    atmo = _atmosphere("cpu")
    table = scattering_table(atmo)
    assert table.dtype == F32 and tuple(table.shape) == (25,)
    i = 0
    for name, size in atmosphere._TABLE_FIELDS:
        assert torch.equal(table[i : i + size], getattr(atmo, name).reshape(-1)), name
        i += size
    radius = atmo.sun_angular_radius
    want = torch.stack([torch.sin(radius), torch.cos(radius), vec_norm(atmo.incident_direction_sun)])
    assert torch.equal(table[i:], want.reshape(-1))


@pytest.mark.parametrize(
    "origin_shape, direction_shape, distance_shape, stride",
    [
        ((3,), (5, 7, 3), (5, 7), 0),
        ((1, 1, 3), (5, 7, 3), (5, 7), 0),
        ((5, 1, 3), (5, 7, 3), (5, 7), 3),
        ((5, 7, 3), (5, 7, 3), (5, 7), 3),
        ((3,), (5, 1, 3), (5, 1), 0),
        ((3,), (3,), (), 0),
    ],
    ids=["shared", "shared_broadcast", "per_row", "per_ray", "rows", "one_ray"],
)
def test_rays_pass_a_shared_origin_once(origin_shape, direction_shape, distance_shape, stride):
    """An origin that broadcasts to one value over the rays is passed once
    (stride 0); any other as one origin a ray (stride 3); directions and
    distances are flattened in the rays' order."""
    g = torch.Generator().manual_seed(3)
    origin = torch.rand(origin_shape, generator=g)
    direction = torch.rand(direction_shape, generator=g)
    distance = torch.rand(distance_shape, generator=g)
    o, got_stride, d, dist, batch = _rays(origin, direction, distance)
    assert got_stride == stride and tuple(batch) == tuple(direction_shape[:-1])
    n = int(np.prod(batch))
    assert o.is_contiguous() and d.is_contiguous() and dist.is_contiguous()
    assert tuple(d.shape) == (n, 3) and tuple(dist.shape) == (n,)
    every = origin.expand(*batch, 3).reshape(-1, 3)
    assert torch.equal(o.expand(n, 3) if stride == 0 else o, every)
    assert torch.equal(d, direction.reshape(-1, 3)) and torch.equal(dist, distance.reshape(-1))


@pytest.mark.parametrize(
    "change, message",
    [
        (lambda a: a.update(origin=a["origin"].double()), "float32"),
        (lambda a: a.update(direction=a["direction"].half()), "float32"),
        (lambda a: a.update(sample_distance=a["sample_distance"].double()), "float32"),
        (lambda a: a.update(origin=a["origin"][:, :2]), "3 components"),
        (lambda a: a.update(direction=a["direction"][:, :, None]), "3 components"),
        (lambda a: a.update(sample_distance=a["sample_distance"][:5]), "broadcast"),
        (lambda a: a.update(lut=a["lut"].half()), "LUT"),
        (lambda a: a.update(lut=a["lut"][..., :2]), "LUT"),
        (lambda a: a.update(lut=a["lut"][0]), "LUT"),
    ],
    ids=["origin_f64", "direction_f16", "distance_f64", "origin_xy", "direction_shape", "distance_shape", "lut_f16",
         "lut_channels", "lut_2d"],
)
def test_launch_refuses_bad_arguments(monkeypatch, change, message):
    """The launch checks dtypes and shapes before it loads anything."""

    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", refuse)
    atmo, lut, origin, direction, distance = _small_case(n=8)
    args = dict(atmo=atmo, lut=lut, origin=origin, direction=direction, sample_distance=distance)
    change(args)
    with pytest.raises(ValueError, match=message):
        atmosphere._launch_kernel(False, *args.values())


def test_launch_refuses_mixed_devices(monkeypatch):
    """Rays on one device and the LUT on another are refused."""
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("loaded"))
    atmo, lut, origin, direction, distance = _small_case(n=8)
    stand_in = types.SimpleNamespace(
        dtype=F32, shape=lut.shape, dim=lut.dim, contiguous=lambda: stand_in, device=torch.device("cuda", 0),
    )
    with pytest.raises(ValueError, match="one device"):
        atmosphere._launch_kernel(True, atmo, stand_in, origin, direction, distance)


def _cuda_stand_in(lut):
    """A transmittance LUT as the dispatch sees it on a card: a device."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=lut.shape)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_dispatch_rule(monkeypatch, form):
    """A LUT on a card launches the kernel in the caller's form, inputs
    that need a gradient too; CPU LUTs take the plain version."""
    launched = []

    def fake_launch(components, atmo, lut, origin, direction, distance):
        launched.append(components)
        out = torch.zeros(distance.shape + (3,))
        return (out, out.clone()) if components else out

    monkeypatch.setattr(atmosphere, "_launch_kernel", fake_launch)
    public, _ = FORMS[form]
    atmo, lut, origin, direction, distance = _small_case(n=8)
    public(atmo, _cuda_stand_in(lut), origin, direction, distance)
    assert launched.pop() == (form == "components")
    needy = direction.clone().requires_grad_(True)
    out = public(atmo, _cuda_stand_in(lut), origin, needy, distance)
    assert launched.pop() == (form == "components")
    assert all(o.grad_fn is not None for o in (out if isinstance(out, tuple) else (out,)))
    public(atmo, lut, origin, direction, distance)
    assert not launched


@pytest.mark.parametrize("form", sorted(FORMS))
def test_cpu_takes_the_plain_version(monkeypatch, form):
    """On the CPU, with and without inputs that need a gradient, each entry
    point is its plain version bitwise and launches nothing (the kernel's
    library is never loaded); the rays include grazing and below-horizon
    ones, distance 0 and steps under 1e-7."""

    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", refuse)
    public, plain = FORMS[form]
    args = _small_case(seed=2)
    before = LAUNCHES.copy()
    got, want = public(*args), plain(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (64, 3) and torch.equal(g, w)
        assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert not got[0][3::8].any()  # distance 0: exactly 0
    origin = args[2].clone().requires_grad_(True)
    out = public(args[0], args[1], origin, *args[3:])
    sum(o.sum() for o in (out if isinstance(out, tuple) else (out,))).backward()
    assert origin.grad is not None and origin.grad[torch.isfinite(origin.grad)].abs().sum() > 0
    assert LAUNCHES.copy() == before


@pytest.mark.parametrize("form", sorted(FORMS))
def test_card_gradient_is_the_plain_versions(form):
    """Where inputs need a gradient on the card, the kernel's output (one
    tensor or the components' two) carries the plain version's gradient:
    checked on the CPU with the plain version standing in for the kernel's
    forward, against autograd through the plain version itself, for the
    origins, directions and distances."""
    _, plain = FORMS[form]
    atmo, lut, origin, direction, distance = _small_case(seed=4, n=32)
    origin, direction, distance = (t.clone().requires_grad_(True) for t in (origin, direction, distance))
    args = (atmo, lut, origin, direction, distance)

    def kernel():
        with torch.no_grad():
            return plain(*args)

    needs = plain_gradient.grad_leaves(args)
    assert [id(t) for t in needs] == [id(origin), id(direction), id(distance)]
    out = plain_gradient.PlainGradient.apply(kernel, plain, args, *needs)
    want_out = plain(*args)
    out, want_out = (out, want_out) if isinstance(out, tuple) else ((out,), (want_out,))
    g = torch.Generator().manual_seed(5)
    weights = [torch.rand(o.shape, generator=g) for o in out]
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, weights)), needs)
    want = torch.autograd.grad(sum((o * w).sum() for o, w in zip(want_out, weights)), needs)
    for a, b in zip(got, want):  # the plain gradient is not finite at distance 0
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        assert a[torch.isfinite(a)].abs().sum() > 0


def test_import_builds_nothing():
    """Importing the atmosphere module loads no CUDA library and starts no
    compiler; the kernel is registered, built without contraction."""
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
        "import syzygy_tpu_torch.kernels.atmosphere as atmosphere\n"
        "from syzygy_tpu_torch.kernels import build\n"
        "bad = [n for n in loaded if n and ('syzygy' in str(n) or 'cuda' in str(n).lower())]\n"
        "assert not bad and not build._loaded, (bad, build._loaded)\n"
        "assert not build.LAUNCHES\n"
        "assert build.SOURCES['scattering'] == ('--fmad=false',)\n"
        "assert list(build.ENTRY_POINTS['scattering']) == ['szg_scattering']\n"
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
        pytest.skip("needs a CUDA GPU (the scattering kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _assert_bitwise(kernel, plain, what):
    kernel, plain = (kernel, plain) if isinstance(kernel, tuple) else ((kernel,), (plain,))
    for k, p in zip(kernel, plain):
        assert k.shape == p.shape and k.dtype == p.dtype, what
        differ = (k != p).any(dim=-1) & ~(torch.isnan(k) & torch.isnan(p)).all(dim=-1)
        assert not differ.any(), (
            f"{what}: {int(differ.sum())} rays differ, first at {differ.nonzero()[:4].tolist()}: "
            f"{k[differ][:4].tolist()} vs {p[differ][:4].tolist()}"
        )


def _both(components: bool, args):
    """The kernel's and the plain version's integral of the same inputs,
    and the launches and rays the kernel's call counted."""
    public, plain = FORMS["components" if components else "luminance"]
    with torch.no_grad():
        before = LAUNCHES.copy()
        kernel = public(*args)
        after = LAUNCHES.copy()
        want = plain(*args)
    torch.cuda.synchronize()
    return kernel, want, after["scattering"] - before["scattering"], after["scattering_rays"] - before["scattering_rays"]


def _frame_calls(device, scene_name: str, **overrides):
    """Every integral call of one eager 1920x1080 frame of the editor's
    default scene (sun animated) or the chess flagship: (components,
    args) in call order."""
    from syzygy_tpu_torch.bench import chess_scene, default_scene_animated
    from syzygy_tpu_torch.renderer.frame import RenderConfig, render_frame_eager
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, library = default_scene_animated() if scene_name == "editor" else chess_scene()
    config = RenderConfig(**(dict(width=1920, height=1080) | overrides))
    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    calls = []
    real = atmosphere._integral

    def spy(components, *args):
        calls.append((components, args))
        return real(components, *args)

    atmosphere._integral = spy
    try:
        with torch.no_grad():
            render_frame_eager(geometry, params, config)
    finally:
        atmosphere._integral = real
    return calls


@pytest.mark.cuda
def test_kernel_matches_plain_lut_frame(cuda):
    """The editor's 1080p frame: the sky-view rows (1,024 rays, components)
    and the aerial froxels (16 x 32 x 32 rays), each from the camera's one
    origin, each one launch, bitwise."""
    calls = _frame_calls(cuda, "editor")
    assert [(c, tuple(a[4].shape)) for c, a in calls] == [(True, (1024, 1)), (False, (16, 32, 32))]
    for components, args in calls:
        assert _rays(*args[2:])[1] == 0
        kernel, plain, launches, rays = _both(components, args)
        _assert_bitwise(kernel, plain, "sky-view rows" if components else "aerial froxels")
        assert launches == 1 and rays == args[4].numel()


@pytest.mark.cuda
def test_kernel_matches_plain_quirk_exact_frame(cuda):
    """The chess flagship's quirk-exact 1080p frame: the sky-view rows,
    the per-pixel integral from the shared eye and the metallic bounce's
    from every pixel's surface (one origin a ray) over 1088 x 1920 rays,
    sky pixels at distance 0 among them; each one launch, bitwise."""
    calls = _frame_calls(cuda, "chess", aerial_lut=False, fast_sky_reflection=False)
    assert [(c, tuple(a[4].shape)) for c, a in calls] == [(True, (1024, 1)), (False, (1088, 1920)), (False, (1088, 1920))]
    assert [_rays(*a[2:])[1] for _, a in calls] == [0, 0, 3]
    assert (calls[1][1][4] == 0).any()
    for (components, args), what in zip(calls, ("sky-view rows", "shared", "bounce")):
        kernel, plain, launches, rays = _both(components, args)
        _assert_bitwise(kernel, plain, what)
        assert launches == 1 and rays == args[4].numel()


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("shared", [False, True], ids=["per_ray", "shared"])
def test_kernel_matches_plain_edge_rays(cuda, form, shared):
    """Seeded rays near the ground at the cells' 512 x 128 transmittance
    LUT: grazing, below-horizon, distance 0 and steps under 1e-7, from one
    origin a ray or one shared origin; bitwise, one launch."""
    atmo = _atmosphere(cuda, time=0.27)
    lut = compute_transmittance_lut(atmo, 512, 128)
    origin, direction, distance = _edge_rays(atmo, 1 << 14, seed=7)
    if shared:
        origin = origin[5].expand(origin.shape)
        distance = raycast_atmosphere(type(atmo)(*[f.cpu() for f in atmo]), origin, direction)
        distance = torch.where(torch.arange(len(distance)) % 8 == 3, 0.0, distance)
        origin = origin[0].to(cuda).expand(origin.shape)  # moved once: .to() would copy it per ray
    args = (atmo, lut, origin.to(cuda), direction.to(cuda), distance.to(cuda))
    assert _rays(*args[2:])[1] == (0 if shared else 3)
    kernel, plain, launches, rays = _both(form == "components", args)
    _assert_bitwise(kernel, plain, f"{form} edge rays")
    assert launches == 1 and rays == 1 << 14
    first = kernel[0] if isinstance(kernel, tuple) else kernel
    assert torch.isfinite(first).all() and not first[3::8].any() and first.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(FORMS))
def test_kernel_gradient_is_the_plain_versions(cuda, form):
    """Inputs that need a gradient on the card: the kernel's integral,
    bitwise, with the plain version's gradient, bitwise."""
    public, plain = FORMS[form]
    atmo = _atmosphere(cuda)
    lut = compute_transmittance_lut(atmo, 512, 128)
    origin, direction, distance = (t.to(cuda) for t in _edge_rays(atmo, 256, seed=9))
    direction = direction.clone().requires_grad_(True)
    args = (atmo, lut, origin, direction, distance)
    before = LAUNCHES["scattering"]
    out = public(*args)
    assert LAUNCHES["scattering"] == before + 1
    want = plain(*args)
    out, want = (out, want) if isinstance(out, tuple) else ((out,), (want,))
    _assert_bitwise(tuple(o.detach() for o in out), tuple(w.detach() for w in want), form)
    g = torch.Generator(cuda).manual_seed(5)
    weights = [torch.rand(o.shape, device=cuda, generator=g) for o in out]
    got = torch.autograd.grad(sum((o * w).sum() for o, w in zip(out, weights)), direction)[0]
    ref = torch.autograd.grad(sum((o * w).sum() for o, w in zip(want, weights)), direction)[0]
    torch.testing.assert_close(got, ref, rtol=0, atol=0, equal_nan=True)
    assert got[torch.isfinite(got)].abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("aerial_lut, integrals", [(True, 2), (False, 3)], ids=["lut", "quirk_exact"])
def test_captured_frame_holds_its_integrals(cuda, aerial_lut, integrals):
    """A replayed frame launches the kernel once per integral: the
    sky-view rows and the aerial froxels, or the sky-view rows, the
    per-pixel integral and the bounce's."""
    from syzygy_tpu_torch.bench import chess_scene
    from syzygy_tpu_torch.renderer.frame import RenderConfig, captured_frames, render_frame_packed
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    scene, library = chess_scene()
    config = RenderConfig(
        width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64, aerial_lut=aerial_lut,
        fast_sky_reflection=False,
    )
    host = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(host)
    geometry = pack_geometry(scene, library, cuda)
    row = flatten_frame_params(host, spec)
    before = LAUNCHES.copy()
    render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    assert LAUNCHES["scattering"] == before["scattering"] + integrals  # the eager frame's
    rays = LAUNCHES["scattering_rays"] - before["scattering_rays"]
    render_frame_packed(geometry, row, spec, config)
    render_frame_packed(geometry, row, spec, config)
    torch.cuda.synchronize()
    assert LAUNCHES["scattering"] == before["scattering"] + 3 * integrals
    assert LAUNCHES["scattering_rays"] == before["scattering_rays"] + 3 * rays
    graph = captured_frames()[-1]
    assert graph["launches"]["scattering"] == integrals and graph["launches"]["scattering_rays"] == rays
