"""The lane gather (K5) and the port's gather bench vs the JAX forms.

``tools/gather_bench.py`` builds its forms inside ``main()``, so they
cannot be imported: the JAX side below restates them, citing the lines.
The g7 ``pallas_call`` is rebuilt with the same kernel body and
BlockSpecs (``:229-258``) and run with ``interpret=True`` on the CPU.
Tolerances: g7, g2, g5 and the index are exact (pure gathers and sums in
the same order); g1, g4, g6 1e-6 (values <= 1, f32 sums that XLA may
contract into fused multiply-adds); g3 2 * 2^-8 (two bf16 roundings of
values <= 1). JAX is imported only inside the tests that compare with
it, so the ``cuda``-marked test also runs on a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gather.py
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from syzygy_tpu_torch.kernels.gather import (
    LAUNCHES,
    lane_gather,
    lane_gather_plain,
    lut_index,
)
from syzygy_tpu_torch.tools import gather_bench as bench

H, W = bench.H, bench.W
S = 8192  # two 4096-sample blocks of the Pallas grid
BLK = 4096


@functools.lru_cache(maxsize=None)
def inputs():
    return bench.bench_inputs(S, seed=0)


def _jnp_index(u, v):
    """``tools/gather_bench.py:240-245``."""
    import jax.numpy as jnp

    uu = jnp.clip(u, 0.0, 1.0) * (W - 1)
    vv = jnp.clip(v, 0.0, 1.0) * (H - 1)
    return jnp.round(vv).astype(jnp.int32) * W + jnp.round(uu).astype(jnp.int32)


def _g7_pallas(flat, idx):
    """The g7 kernel and its ``pallas_call`` (``:234-237``, ``:246-257``)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    def kernel(idx_ref, lut_ref, out_ref):
        idx = idx_ref[:]
        out_ref[:] = lut_ref[idx]

    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((idx.shape[0],), jnp.float32),
        grid=(idx.shape[0] // BLK,),
        in_specs=[
            pl.BlockSpec((BLK,), lambda i: (i,), memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BLK,), lambda i: (i,), memory_space=pltpu.VMEM),
        interpret=True,
    )(idx, flat)


def test_lane_gather_matches_pallas_g7():
    """lane_gather_plain and the CPU lane_gather equal the Pallas g7 call
    bitwise on the bench's seeded inputs."""
    import jax.numpy as jnp

    d = inputs()
    flat_np = d["lut"][:, :, 0].reshape(-1)
    ref = np.asarray(_g7_pallas(jnp.asarray(flat_np), _jnp_index(jnp.asarray(d["u"]), jnp.asarray(d["v"]))))
    flat = torch.from_numpy(flat_np.copy())
    idx = lut_index(torch.from_numpy(d["u"]), torch.from_numpy(d["v"]), H, W)
    np.testing.assert_array_equal(lane_gather_plain(flat, idx).numpy(), ref)
    before = LAUNCHES.lane_gather
    np.testing.assert_array_equal(lane_gather(flat, idx).numpy(), ref)
    assert LAUNCHES.lane_gather == before  # the CPU takes the plain version
    np.testing.assert_array_equal(bench.g7(flat, torch.from_numpy(d["u"]), torch.from_numpy(d["v"])).numpy(), ref)


def test_index_matches_jnp_round_half_even():
    """lut_index equals the jnp index, including exact .5 texel positions
    (round half to even) and clipped inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    halves_u = ((np.arange(0, W - 1) + 0.5) / (W - 1)).astype(np.float32)
    halves_v = ((np.arange(0, H - 1) + 0.5) / (H - 1)).astype(np.float32)
    u = np.concatenate([rng.random(4096, np.float32), halves_u, np.resize(halves_v, W - 1), [-0.5, 1.5, 0.0, 1.0]]).astype(np.float32)
    v = np.concatenate([rng.random(4096, np.float32), np.resize(halves_v, W - 1), halves_u * 0 + 0.5, [2.0, -1.0, 1.0, 0.0]]).astype(np.float32)
    ref = np.asarray(_jnp_index(jnp.asarray(u), jnp.asarray(v)))
    port = lut_index(torch.from_numpy(u), torch.from_numpy(v), H, W).numpy()
    assert port.dtype == np.int32
    np.testing.assert_array_equal(port, ref)
    assert ref.min() >= 0 and ref.max() < H * W


# --- the jnp forms of tools/gather_bench.py, restated -----------------------


@functools.lru_cache(maxsize=None)
def jnp_forms():
    import jax
    import jax.numpy as jnp

    def _uv(u, v):
        return jnp.clip(u, 0.0, 1.0) * (W - 1), jnp.clip(v, 0.0, 1.0) * (H - 1)

    def jnp_g1(lut, u, v):  # :85-104
        uu, vv = _uv(u, v)
        x0 = jnp.floor(uu).astype(jnp.int32)
        y0 = jnp.floor(vv).astype(jnp.int32)
        x1 = jnp.minimum(x0 + 1, W - 1)
        y1 = jnp.minimum(y0 + 1, H - 1)
        fx = (uu - x0)[..., None]
        fy = (vv - y0)[..., None]
        return (
            lut[y0, x0] * (1 - fx) * (1 - fy) + lut[y0, x1] * fx * (1 - fy)
            + lut[y1, x0] * (1 - fx) * fy + lut[y1, x1] * fx * fy
        )

    def jnp_g2(lut, u, v):  # :109-116
        uu, vv = _uv(u, v)
        idx = jnp.round(vv).astype(jnp.int32) * W + jnp.round(uu).astype(jnp.int32)
        return lut.reshape(-1, 3)[idx]

    def jnp_g3(lut, u, v):  # :121-143
        n_s = u.shape[0]
        uu, vv = _uv(u, v)
        y0 = jnp.floor(vv).astype(jnp.int32)
        fy = (vv - y0)[..., None]
        iy = jax.lax.broadcasted_iota(jnp.int32, (n_s, H), 1)
        wv = jnp.where(iy == y0[:, None], 1.0 - fy, 0.0) + jnp.where(iy == jnp.minimum(y0 + 1, H - 1)[:, None], fy, 0.0)
        rows = (wv.astype(jnp.bfloat16) @ lut.reshape(H, W * 3).astype(jnp.bfloat16)).reshape(n_s, W, 3)
        x0 = jnp.floor(uu).astype(jnp.int32)
        fx = (uu - x0)[..., None]
        ix = jax.lax.broadcasted_iota(jnp.int32, (n_s, W), 1)
        wu = jnp.where(ix == x0[:, None], 1.0 - fx, 0.0) + jnp.where(ix == jnp.minimum(x0 + 1, W - 1)[:, None], fx, 0.0)
        return jnp.einsum("sw,swc->sc", wu.astype(jnp.bfloat16), rows).astype(jnp.float32)

    def jnp_g4(coef, u, v):  # :162-175
        x = jnp.clip(u, 0.0, 1.0) * 2.0 - 1.0
        y = jnp.clip(v, 0.0, 1.0) * 2.0 - 1.0

        def cheb(t, k):
            outs = [jnp.ones_like(t), t]
            for _ in range(k - 2):
                outs.append(2.0 * t * outs[-1] - outs[-2])
            return jnp.stack(outs[:k], axis=-1)

        return jnp.einsum("su,sv,uvc->sc", cheb(x, 10), cheb(y, 6), coef)

    def jnp_g5(shadow, u, v):  # :180-191
        uu = jnp.clip(u, 0.0, 1.0) * 1023.0
        vv = jnp.clip(v, 0.0, 1.0) * 1023.0
        x0 = jnp.floor(uu).astype(jnp.int32)
        y0 = jnp.floor(vv).astype(jnp.int32)
        acc = jnp.zeros_like(uu)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                acc = acc + shadow[jnp.clip(y0 + dy, 0, 1023), jnp.clip(x0 + dx, 0, 1023)]
        return acc

    def jnp_g6(quad, u, v):  # :206-217
        uu, vv = _uv(u, v)
        x0 = jnp.floor(uu).astype(jnp.int32)
        y0 = jnp.floor(vv).astype(jnp.int32)
        fx = (uu - x0)[..., None]
        fy = (vv - y0)[..., None]
        q = quad[y0 * W + x0]
        top = q[:, 0:3] * (1 - fx) + q[:, 3:6] * fx
        bot = q[:, 6:9] * (1 - fx) + q[:, 9:12] * fx
        return top * (1 - fy) + bot * fy

    return {"g1": jnp_g1, "g2": jnp_g2, "g3": jnp_g3, "g4": jnp_g4, "g5": jnp_g5, "g6": jnp_g6}


_SMALL = 2048
_FORMS = {
    # name: (port form, table key, tolerance)
    "g1": (bench.g1, "lut", 1e-6),
    "g2": (bench.g2, "lut", 0.0),
    "g3": (bench.g3, "lut", 2 * 2.0**-8),
    "g4": (bench.g4, "coef", 1e-6),
    "g5": (bench.g5, "shadow", 0.0),
    "g6": (bench.g6, "quad", 1e-6),
}


@pytest.mark.parametrize("form", sorted(_FORMS))
def test_bench_form_matches_jnp(form):
    import jax
    import jax.numpy as jnp

    port_fn, key, atol = _FORMS[form]
    jnp_fn = jnp_forms()[form]
    d = inputs()
    table = bench.quad_table(d["lut"]) if key == "quad" else d[key]
    u, v = d["u"][:_SMALL], d["v"][:_SMALL]
    ref = np.asarray(jax.jit(jnp_fn)(jnp.asarray(table), jnp.asarray(u), jnp.asarray(v)))
    port = port_fn(torch.from_numpy(table), torch.from_numpy(u), torch.from_numpy(v)).numpy()
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, atol=atol, rtol=0)


def test_bench_main_on_cpu(capsys):
    """``python -m syzygy_tpu_torch.tools.gather_bench 0.004 --device cpu``:
    every form runs and prints; g7's checksum is the plain gather's sum."""
    result = bench.main(["0.004", "--device", "cpu"])
    assert result["samples"] == 3072
    assert sorted(result["forms"]) == [f"g{i}" for i in range(1, 8)]
    out = capsys.readouterr().out
    assert "g7 lane gather kernel" in out and "gather bench complete" in out
    d = bench.bench_inputs(3072)
    flat = torch.from_numpy(d["lut"][:, :, 0].reshape(-1).copy())
    plain = lane_gather_plain(flat, lut_index(torch.from_numpy(d["u"]), torch.from_numpy(d["v"]), H, W))
    assert result["forms"]["g7"]["checksum"] == float(plain.double().sum())


def test_bench_refuses_a_missing_card():
    """The default device is the card: without one the bench refuses."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["0.001"])


@pytest.mark.parametrize(
    "case",
    ["float64 table", "int64 indices", "2-D table", "strided indices", "index past the end", "negative index"],
)
def test_lane_gather_refuses(case):
    """The wrapper raises on anything the kernel does not take."""
    flat = torch.arange(16, dtype=torch.float32)
    idx = torch.tensor([0, 3, 15], dtype=torch.int32)
    if case == "float64 table":
        flat = flat.double()
    elif case == "int64 indices":
        idx = idx.long()
    elif case == "2-D table":
        flat = flat.reshape(4, 4)
    elif case == "strided indices":
        idx = torch.arange(8, dtype=torch.int32)[::2]
    elif case == "index past the end":
        idx = torch.tensor([0, 16], dtype=torch.int32)
    else:
        idx = torch.tensor([-1, 2], dtype=torch.int32)
    with pytest.raises((ValueError, IndexError)):
        lane_gather(flat, idx)


def test_cuda_tensor_never_falls_back_to_plain(monkeypatch):
    """A CUDA tensor goes to the kernel launcher, never to the plain
    version."""
    from syzygy_tpu_torch.kernels import gather

    calls = []
    monkeypatch.setattr(gather, "_check", lambda *a: None)
    monkeypatch.setattr(gather, "lane_gather_plain", lambda *a: calls.append("plain"))
    monkeypatch.setattr(gather, "_launch", lambda *a: calls.append("kernel"))

    class FakeCuda:
        type = "cuda"

    class Table:
        device = FakeCuda()

    gather.lane_gather(Table(), None)
    assert calls == ["kernel"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the lane gather kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    """The kernel equals the plain gather bitwise at the bench's default
    size, with one counted launch."""
    n = bench.sample_count(2.0)
    d = bench.bench_inputs(n)
    flat = torch.from_numpy(d["lut"][:, :, 0].reshape(-1).copy()).to(cuda)
    idx = lut_index(torch.from_numpy(d["u"]).to(cuda), torch.from_numpy(d["v"]).to(cuda), H, W)
    before = LAUNCHES.lane_gather
    out = lane_gather(flat, idx)
    assert LAUNCHES.lane_gather == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, lane_gather_plain(flat, idx))
