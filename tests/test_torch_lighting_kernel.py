"""The CUDA lighting kernel vs its plain torch version, without JAX.

This file imports only torch and the port, so it also runs on a GPU host
that has no JAX (the repository's ``conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_lighting_kernel.py

The ``cuda``-marked tests hold ``csrc/lighting.cu`` bitwise to
``deferred_lighting_plain`` on the card: the editor's default scene and
the chess flagship at 1920x1088 with 8192^2 maps, every one of the 2 + 16
light slots live, a dim directional light lit without its map
(``shadowless_eps > 0``), the sun's shared PCF, f16 and q8 maps of 256
and 2048 texels, a row block at a non-zero origin and an all-background
target (no slot evaluated); inputs that need a gradient (the plain
version's gradient); and a captured frame's graph, which holds one
lighting launch. They skip without a GPU. The unmarked ones check on the
CPU the slot table the kernel reads (bitwise the plain version's per-slot
values), which inputs launch the kernel and with which tap format, that
CPU inputs take the plain version, that the card's gradient is the plain
version's, and that importing the module builds nothing.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.bench import all_slots_live
from syzygy_tpu_torch.kernels import lighting, plain_gradient
from syzygy_tpu_torch.kernels.lighting import (
    LAUNCHES,
    TABLE_STRIDE,
    _TO_TEX_COORD,
    _normalize,
    _take,
    deferred_lighting,
    deferred_lighting_plain,
    evaluated_slots,
    last_slot_mask,
    light_activity,
    light_table,
)
from syzygy_tpu_torch.math.geometry import matmul4
from syzygy_tpu_torch.scene.lights import DirectionalLight, SpotLight

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = torch.float32


def _seeded_lights(seed: int, n_spot: int = 16):
    """Two directional lights and ``n_spot`` spots with seeded, non-trivial
    light matrices (every product of the shadow frame's chain rounds)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def fields(n):
        return dict(
            color=t(np.concatenate([rng.uniform(0.2, 1.0, (n, 3)), np.ones((n, 1))], -1)),
            forward=t(np.concatenate([rng.normal(size=(n, 3)), np.zeros((n, 1))], -1)),
            projection=t(rng.normal(size=(n, 4, 4))),
            view=t(rng.normal(size=(n, 4, 4))),
            strength=t(rng.uniform(0.1, 3.0, n)),
        )

    directional = DirectionalLight(**fields(2))
    spots = SpotLight(
        **fields(n_spot),
        position=t(np.concatenate([rng.uniform(-20, 20, (n_spot, 3)), np.ones((n_spot, 1))], -1)),
        falloff_factor=t(rng.uniform(0.1, 2.0, n_spot)),
        falloff_distance=t(rng.uniform(1.0, 40.0, n_spot)),
    )
    return directional, spots


def _scene_lights():
    """The editor's default scene's lights, as its frame state holds them."""
    from syzygy_tpu_torch.bench import default_scene_animated
    from syzygy_tpu_torch.scene.pack import pack_frame_params, prepare_frame_state, upload_frame_params

    scene, _ = default_scene_animated()
    state = prepare_frame_state(upload_frame_params(pack_frame_params(scene, 16 / 9), "cpu"))
    return state.directional_lights, state.spot_lights


@pytest.mark.parametrize("lights", ["seeded", "editor"])
def test_light_table_is_the_plain_per_slot_values(lights):
    """Every row of ``light_table`` holds, bitwise, what
    ``deferred_lighting_plain`` computes for that slot alone: the shadow
    frame's matrix, the normalized direction, color x strength, and a
    spot's position and falloff."""
    directional, spots = _seeded_lights(5) if lights == "seeded" else _scene_lights()
    table = light_table(directional, spots)
    n_dir, n_spot = directional.strength.shape[0], spots.strength.shape[0]
    assert table.shape == (n_dir + n_spot, TABLE_STRIDE) and table.dtype == F32
    to_tex = torch.tensor(_TO_TEX_COORD, dtype=F32)
    for slot in range(n_dir + n_spot):
        light = _take(directional, slot) if slot < n_dir else _take(spots, slot - n_dir)
        row = table[slot]
        frame = matmul4(to_tex, matmul4(light.projection, light.view))
        assert torch.equal(row[:16], frame.reshape(16)), slot
        assert torch.equal(row[16:19], _normalize(-light.forward[:3])), slot
        assert torch.equal(row[19:22], light.color[:3] * light.strength), slot
        if slot >= n_dir:
            assert torch.equal(row[22:25], light.position[:3]), slot
            assert torch.equal(row[25:27], torch.stack([light.falloff_factor, light.falloff_distance])), slot
        else:
            assert not row[22:27].any(), slot
        assert not row[27:].any(), slot


def test_q8_tables_are_each_maps_segments():
    """``q8_tables`` stacks each map's ``_q8_segments`` (what the plain
    version decodes), the codes exactly in f16."""
    rng = np.random.default_rng(8)
    maps = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 40, 40)).astype(np.float32))
    maps[1, :, :12] = 0.0  # empty segments: a zero range
    codes, lo16, step16, n_w = lighting.q8_tables(maps)
    assert codes.dtype == torch.float16 and n_w == (40 + 2 * lighting.PCF_PAD) // 8
    for m in range(3):
        c, lo, step, w = lighting._q8_segments(maps[m])
        assert w == n_w and torch.equal(codes[m].float(), c)
        assert torch.equal(lo16[m], lo) and torch.equal(step16[m], step)


def test_all_slots_live_lights_every_slot():
    """``bench.all_slots_live`` on the editor scene's frame state: both
    directional slots and all 16 spot slots live (the gate off), spot
    slot j given map j % 3, the scene's own maps left alone."""
    from syzygy_tpu_torch.bench import default_scene_animated
    from syzygy_tpu_torch.scene.pack import pack_frame_params, prepare_frame_state, upload_frame_params

    scene, _ = default_scene_animated()
    state = prepare_frame_state(upload_frame_params(pack_frame_params(scene, 16 / 9), "cpu"))
    maps = torch.arange(18 * 4, dtype=F32).reshape(18, 2, 2)
    lights, mixed = all_slots_live(state, maps)
    activity = light_activity(*lights.values(), 0.0, 18)
    assert activity.shadowed_dirs.all() and activity.spots.all() and not activity.unshadowed_dirs.any()
    assert torch.equal(mixed[:2], maps[:2]) and torch.equal(maps, torch.arange(18 * 4, dtype=F32).reshape(18, 2, 2))
    assert all(torch.equal(mixed[2 + j], maps[j % 3]) for j in range(16))
    assert len({tuple(p) for p in lights["spots"].position[:, :3].tolist()}) == 16


def _cuda_stand_in(shape):
    """Shadow maps as the dispatch sees them on a card: a device and a
    shape, no storage."""
    return types.SimpleNamespace(device=torch.device("cuda", 0), shape=tuple(shape))


def _small_case(seed: int):
    """deferred_lighting's positional inputs on the CPU at 8x64 pixels,
    2 directional lights and 4 spots with identity light matrices, 6 maps
    of 32^2 texels."""
    directional, spots = _seeded_lights(seed, n_spot=4)
    directional = directional._replace(projection=torch.eye(4).expand(2, 4, 4), view=torch.eye(4).expand(2, 4, 4))
    spots = spots._replace(projection=torch.eye(4).expand(4, 4, 4), view=torch.eye(4).expand(4, 4, 4))
    gbuffer = _seeded_gbuffer(seed)
    camera = types.SimpleNamespace(position=torch.tensor([0.5, -3.0, 0.2, 1.0]))
    maps = torch.from_numpy(np.random.default_rng(seed).uniform(size=(6, 32, 32)).astype(np.float32))
    counts = [torch.tensor(2, dtype=torch.int32), torch.tensor(0, dtype=torch.int32), torch.tensor(4, dtype=torch.int32)]
    return [gbuffer, camera, directional, counts[0], counts[1], spots, counts[2], maps]


def test_dispatch_rule(monkeypatch):
    """Maps on a card launch the kernel, whatever the flags: f16 taps for
    ``pcf_f16`` and q8 segments for ``pcf_q8`` at up to
    ``PCF_WINDOW_MAX_DIM`` texels, f32 taps above it, and inputs that
    need a gradient too; CPU maps take the plain version."""
    launched = []

    def fake_launch(gbuffer, camera, directional, spots, maps, eps, activity, f16, q8, sun_shadow):
        launched.append((maps.shape[-1], f16, q8))
        return torch.zeros(gbuffer.diffuse.shape[:2] + (3,))

    monkeypatch.setattr(lighting, "_launch_kernel", fake_launch)
    args = _small_case(1)
    maps = args[7]
    small = _cuda_stand_in(maps.shape)
    big = _cuda_stand_in((6, 2 * lighting.PCF_WINDOW_MAX_DIM, 2 * lighting.PCF_WINDOW_MAX_DIM))
    for card_maps, flags, want in [
        (small, {}, (32, False, False)),
        (small, dict(pcf_f16=True), (32, True, False)),
        (small, dict(pcf_q8=True), (32, False, True)),
        (small, dict(pcf_f16=True, pcf_q8=True), (32, True, True)),
        (big, dict(pcf_f16=True, pcf_q8=True), (big.shape[-1], False, False)),
    ]:
        deferred_lighting(*args[:7], card_maps, **flags)
        assert launched.pop() == want, flags
    color = args[2].color.clone().requires_grad_(True)
    lit = deferred_lighting(*args[:2], args[2]._replace(color=color), *args[3:7], small)
    assert launched.pop() == (32, False, False) and lit.grad_fn is not None
    deferred_lighting(*args)
    assert not launched


def test_card_gradient_is_the_plain_versions():
    """Where inputs need a gradient on the card, the kernel's output
    carries the plain version's gradient: checked on the CPU with the
    plain version standing in for the kernel's forward, against autograd
    through the plain version itself, for the light colors, the spots'
    strengths, the G-buffer's normals and the shared sun PCF."""
    args = _small_case(3)
    color = args[2].color.clone().requires_grad_(True)
    strength = args[5].strength.clone().requires_grad_(True)
    normal = args[0].normal.clone().requires_grad_(True)
    sun = torch.rand(8, 64, generator=torch.Generator().manual_seed(3)).requires_grad_(True)
    args[2] = args[2]._replace(color=color)
    args[5] = args[5]._replace(strength=strength)
    args[0] = args[0]._replace(normal=normal)
    every = (*args, sun)
    flags = dict(pcf_f16=True, shadowless_eps=0.025)

    def plain(*a):
        return deferred_lighting_plain(*a[:-1], sun_shadow=a[-1], **flags)

    def kernel():
        with torch.no_grad():
            return plain(*every)

    needs = plain_gradient.grad_leaves(every)
    assert [id(t) for t in needs] == [id(normal), id(color), id(strength), id(sun)]
    lit = plain_gradient.PlainGradient.apply(kernel, plain, every, *needs)
    weights = torch.rand(lit.shape, generator=torch.Generator().manual_seed(4))
    got = torch.autograd.grad((lit * weights).sum(), needs)
    want = torch.autograd.grad((plain(*every) * weights).sum(), needs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert all(g.abs().sum() > 0 for g in got)


def _seeded_gbuffer(seed: int, h: int = 8, w: int = 64):
    rng = np.random.default_rng(seed)
    normal = rng.normal(size=(h, w, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    alpha = (rng.uniform(size=(h, w, 1)) > 1 / 8).astype(np.float32)
    planes = [
        np.concatenate([rng.uniform(0.1, 0.9, (h, w, 3)), alpha], -1),
        np.concatenate([rng.uniform(0.0, 1.0, (h, w, 3)), np.ones((h, w, 1))], -1),
        np.concatenate([normal, np.zeros((h, w, 1))], -1),
        np.concatenate([rng.uniform(-0.9, 0.9, (h, w, 2)), rng.uniform(0.05, 0.95, (h, w, 1)), np.ones((h, w, 1))], -1),
        np.concatenate([rng.uniform(0.0, 1.0, (h, w, 3)), np.ones((h, w, 1))], -1),
    ]
    from syzygy_tpu_torch.kernels.resolve import GBuffer

    return GBuffer(*[torch.from_numpy(p.astype(np.float32)) for p in planes])


def test_cpu_and_grad_inputs_take_the_plain_version(monkeypatch):
    """On the CPU, and with inputs that require grad, ``deferred_lighting``
    is ``deferred_lighting_plain`` bitwise and launches nothing (the
    kernel's library is never loaded)."""
    from syzygy_tpu_torch.kernels import build

    def refuse(name):
        raise AssertionError(f"library {name} loaded")

    monkeypatch.setattr(build, "load", refuse)
    args = _small_case(2)
    gbuffer, camera, directional, spots, maps = args[0], args[1], args[2], args[5], args[7]
    counts = [args[3], args[4], args[6]]
    before = LAUNCHES.lighting
    got = deferred_lighting(*args, pcf_f16=True, shadowless_eps=0.025)
    assert torch.equal(got, deferred_lighting_plain(*args, pcf_f16=True, shadowless_eps=0.025))
    assert got.abs().sum() > 0
    color = directional.color.clone().requires_grad_(True)
    lit = deferred_lighting(gbuffer, camera, directional._replace(color=color), *counts[:2], spots, counts[2], maps)
    lit.sum().backward()
    assert color.grad is not None and color.grad.abs().sum() > 0
    assert LAUNCHES.lighting == before
    assert last_slot_mask("cpu") is None and evaluated_slots(None) is None


def test_import_builds_nothing():
    """Importing the lighting module loads no CUDA library and starts no
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
        "import syzygy_tpu_torch.kernels.lighting as lighting\n"
        "from syzygy_tpu_torch.kernels import build\n"
        "bad = [n for n in loaded if n and ('syzygy' in str(n) or 'cuda' in str(n).lower())]\n"
        "assert not bad and not build._loaded, (bad, build._loaded)\n"
        "assert lighting.LAUNCHES.lighting == 0\n"
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
        pytest.skip("needs a CUDA GPU (the lighting kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _frame(device, scene_name: str, row0: int = 0, rows: int | None = None, **overrides):
    """The frame state, G-buffer and shadow maps of rows ``[row0, row0 +
    rows)`` of a 1920x1080 frame (1088 padded rows) of the editor's
    default scene (its sun animated, ``bench.py``'s camera) or the chess
    flagship, at 8192^2 maps unless ``overrides`` say otherwise, and the
    config."""
    from syzygy_tpu_torch.bench import chess_scene, default_scene_animated
    from syzygy_tpu_torch.renderer.frame import RenderConfig, _geometry
    from syzygy_tpu_torch.scene.pack import pack_frame_params, pack_geometry, upload_frame_params

    scene, library = default_scene_animated() if scene_name == "editor" else chess_scene()
    config = RenderConfig(**(dict(width=1920, height=1080, shadow_dim=8192) | overrides))
    geometry = pack_geometry(scene, library, device)
    params = upload_frame_params(pack_frame_params(scene, config.width / config.height), device)
    rows = config.padded_height - row0 if rows is None else rows
    with torch.no_grad():
        state, _, gbuffer, maps, _ = _geometry(geometry, params, config, row0, rows)
    return state, gbuffer, maps, config


def _both(state, gbuffer, maps, config, sun_shadow=None, **changes):
    """The kernel's and the plain version's lighting of the same inputs,
    the kernel's launches, and the slots that ``light_activity`` marks
    live."""
    lights = dict(
        directional=state.directional_lights, directional_count=state.directional_count,
        directional_skip=state.directional_skip_count, spots=state.spot_lights, spot_count=state.spot_count,
    ) | changes
    args = (
        gbuffer, state.camera, lights["directional"], lights["directional_count"], lights["directional_skip"],
        lights["spots"], lights["spot_count"], maps,
    )
    flags = dict(
        pcf_f16=config.pcf_f16, pcf_q8=config.pcf_q8, shadowless_eps=config.shadowless_strength_eps,
        sun_shadow=sun_shadow,
    )
    with torch.no_grad():
        before = LAUNCHES.lighting
        kernel = deferred_lighting(*args, **flags)
        launched = LAUNCHES.lighting - before
        plain = deferred_lighting_plain(*args, **flags)
    torch.cuda.synchronize()
    activity = light_activity(
        lights["directional"], lights["directional_count"], lights["directional_skip"], lights["spots"],
        lights["spot_count"], config.shadowless_strength_eps, maps.shape[0],
    )
    live = int(activity.shadowed_dirs.sum() + activity.unshadowed_dirs.sum() + activity.spots.sum())
    return kernel, plain, launched, live


def _assert_bitwise(kernel, plain):
    assert kernel.shape == plain.shape and kernel.dtype == plain.dtype
    differ = (kernel != plain).any(dim=-1)
    assert not differ.any(), (
        f"{int(differ.sum())} pixels differ, first at {differ.nonzero()[:4].tolist()}: "
        f"{kernel[differ][:4].tolist()} vs {plain[differ][:4].tolist()}"
    )


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["editor", "chess"])
def test_kernel_matches_plain_scene(cuda, scene):
    """The cells' settings: 1920x1088, 8192^2 maps read in f32, the dim
    moon's gate; one launch, the live slots alone evaluated (3 at most)."""
    state, gbuffer, maps, config = _frame(cuda, scene)
    kernel, plain, launched, live = _both(state, gbuffer, maps, config)
    _assert_bitwise(kernel, plain)
    assert launched == 1
    assert evaluated_slots(last_slot_mask(cuda)) == live <= 3
    assert (kernel != 0).any()


@pytest.mark.cuda
def test_kernel_matches_plain_every_slot_live(cuda):
    """All 2 + 16 slots live at 8192^2: 18 slots evaluated in one launch."""
    state, gbuffer, maps, config = _frame(cuda, "editor", shadowless_strength_eps=0.0)
    changes, mixed = all_slots_live(state, maps)
    kernel, plain, launched, live = _both(state, gbuffer, mixed, config, **changes)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and live == 18
    assert evaluated_slots(last_slot_mask(cuda)) == 18


@pytest.mark.cuda
def test_kernel_matches_plain_dim_light_unshadowed(cuda):
    """``shadowless_eps > 0`` with the moon dim against the sun (both
    live): the sun lit with its map, the moon without, after it."""
    state, gbuffer, maps, config = _frame(cuda, "editor", shadow_dim=2048)
    d = state.directional_lights
    dim = d._replace(strength=torch.tensor([3.0, 0.01], device=cuda))
    count, skip = torch.tensor(2, dtype=torch.int32, device=cuda), torch.tensor(0, dtype=torch.int32, device=cuda)
    changes = dict(directional=dim, directional_count=count, directional_skip=skip)
    activity = light_activity(dim, count, skip, state.spot_lights, state.spot_count,
                              config.shadowless_strength_eps, maps.shape[0])
    assert config.shadowless_strength_eps > 0
    assert activity.shadowed_dirs.tolist() == [True, False] and activity.unshadowed_dirs.tolist() == [False, True]
    kernel, plain, launched, live = _both(state, gbuffer, maps, config, **changes)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and evaluated_slots(last_slot_mask(cuda)) == live


@pytest.mark.cuda
def test_kernel_matches_plain_shared_sun_pcf(cuda):
    """``share_sun_pcf``: the sun's PCF given, in place of slot 0's taps."""
    from syzygy_tpu_torch.renderer.frame import _sun_pcf

    state, gbuffer, maps, config = _frame(cuda, "chess", share_sun_pcf=True)
    with torch.no_grad():
        sun = _sun_pcf(state, gbuffer, maps, config)
    kernel, plain, launched, _ = _both(state, gbuffer, maps, config, sun_shadow=sun)
    _assert_bitwise(kernel, plain)
    assert launched == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [256, 2048])
def test_kernel_matches_plain_f16_maps(cuda, dim):
    """``pcf_f16`` maps of at most 2048 texels: every tap rounded to f16."""
    state, gbuffer, maps, config = _frame(cuda, "editor", shadow_dim=dim)
    assert config.pcf_f16
    kernel, plain, launched, _ = _both(state, gbuffer, maps, config)
    _assert_bitwise(kernel, plain)
    assert launched == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [256, 2048])
def test_kernel_matches_plain_q8_maps(cuda, dim):
    """``pcf_q8`` maps of at most 2048 texels: every tap decoded from its
    u8 segment, on the chess scene and with all 2 + 16 slots live."""
    state, gbuffer, maps, config = _frame(cuda, "chess", shadow_dim=dim, pcf_q8=True)
    kernel, plain, launched, _ = _both(state, gbuffer, maps, config)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and (kernel != 0).any()
    state, gbuffer, maps, config = _frame(cuda, "editor", shadow_dim=dim, pcf_q8=True, shadowless_strength_eps=0.0)
    changes, mixed = all_slots_live(state, maps)
    kernel, plain, launched, live = _both(state, gbuffer, mixed, config, **changes)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and evaluated_slots(last_slot_mask(cuda)) == live == 18


@pytest.mark.cuda
def test_kernel_row_block(cuda):
    """Rows [512, 1088) as a block at a non-zero origin: bitwise the plain
    version's block and the whole frame's rows."""
    state, gbuffer, maps, config = _frame(cuda, "chess", row0=512)
    kernel, plain, launched, _ = _both(state, gbuffer, maps, config)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and kernel.shape[0] == 576
    whole_state, whole_gbuffer, whole_maps, _ = _frame(cuda, "chess")
    whole, _, _, _ = _both(whole_state, whole_gbuffer, whole_maps, config)
    _assert_bitwise(kernel, whole[512:])


@pytest.mark.cuda
def test_kernel_all_background(cuda):
    """A target without a lit pixel: zeros, as the plain version's, and no
    slot evaluated, though the masks mark slots live."""
    state, gbuffer, maps, config = _frame(cuda, "editor", shadow_dim=256)
    empty = gbuffer._replace(diffuse=torch.cat([gbuffer.diffuse[..., :3], torch.zeros_like(gbuffer.diffuse[..., 3:])], -1))
    kernel, plain, launched, live = _both(state, empty, maps, config)
    _assert_bitwise(kernel, plain)
    assert launched == 1 and not kernel.any()
    assert live > 0 and evaluated_slots(last_slot_mask(cuda)) == 0


@pytest.mark.cuda
def test_kernel_gradient_is_the_plain_versions(cuda):
    """Inputs that need a gradient on the card: the kernel's lighting,
    bitwise, with the plain version's gradient, bitwise."""
    state, gbuffer, maps, config = _frame(cuda, "editor", width=256, height=128, shadow_dim=256)
    color = state.directional_lights.color.clone().requires_grad_(True)
    normal = gbuffer.normal.clone().requires_grad_(True)
    args = (
        gbuffer._replace(normal=normal), state.camera, state.directional_lights._replace(color=color),
        state.directional_count, state.directional_skip_count, state.spot_lights, state.spot_count, maps,
    )
    flags = dict(pcf_f16=config.pcf_f16, shadowless_eps=config.shadowless_strength_eps)
    before = LAUNCHES.lighting
    lit = deferred_lighting(*args, **flags)
    assert LAUNCHES.lighting == before + 1
    plain = deferred_lighting_plain(*args, **flags)
    _assert_bitwise(lit.detach(), plain.detach())
    weights = torch.rand(lit.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(5))
    got = torch.autograd.grad((lit * weights).sum(), (color, normal))
    want = torch.autograd.grad((plain * weights).sum(), (color, normal))
    for g, w in zip(got, want):
        assert torch.equal(g, w) and g.abs().sum() > 0


@pytest.mark.cuda
def test_captured_frame_holds_one_lighting_launch(cuda):
    """A replayed frame launches the lighting kernel once, and its graph
    reports the slots its own lighting launch evaluated in the last
    replay, whatever a later launch outside it evaluates."""
    from syzygy_tpu_torch.bench import default_scene_animated
    from syzygy_tpu_torch.renderer.frame import RenderConfig, captured_frames, render_frame_packed
    from syzygy_tpu_torch.scene.pack import flatten_frame_params, frame_param_spec, pack_frame_params, pack_geometry

    scene, library = default_scene_animated()
    config = RenderConfig(width=256, height=128, shadow_dim=256, skyview_width=128, skyview_height=64)
    host = pack_frame_params(scene, config.width / config.height)
    spec = frame_param_spec(host)
    geometry = pack_geometry(scene, library, cuda)
    row = flatten_frame_params(host, spec)
    before = LAUNCHES.lighting
    render_frame_packed(geometry, row, spec, config)  # the eager frame and the capture
    assert LAUNCHES.lighting == before + 1  # the eager frame's; the captured one is not launched
    render_frame_packed(geometry, row, spec, config)
    render_frame_packed(geometry, row, spec, config)
    torch.cuda.synchronize()
    assert LAUNCHES.lighting == before + 3
    graph = captured_frames()[-1]
    assert graph["launches"]["lighting"] == 1
    assert 1 <= graph["lighting_slots"]() <= 3
    state, gbuffer, maps, config = _frame(cuda, "editor", width=256, height=128, shadow_dim=256)
    empty = gbuffer._replace(diffuse=torch.zeros_like(gbuffer.diffuse))
    _both(state, empty, maps, config)
    assert evaluated_slots(last_slot_mask(cuda)) == 0 and 1 <= graph["lighting_slots"]() <= 3
