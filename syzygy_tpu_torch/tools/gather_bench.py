"""Micro-benchmark of LUT-sampling formulations on one device.

Counterpart of ``tools/gather_bench.py`` for the port. The frame's
per-pixel passes sample LUTs by data-dependent gathers (transmittance-LUT
bilinear, the 25-tap PCF, the texture atlas); this times each form per
sample on seeded inputs (a 128x512x3 LUT, S uniform (u, v) pairs, a
1024^2 shadow map):

  g1. fancy-index bilinear gather from the 128x512x3 LUT
  g2. flat 1-D nearest gather (one index per sample)
  g3. one-hot bf16 matmul interpolation (on min(S, 65536) samples)
  g4. 2-D Chebyshev evaluation, 10x6 terms per channel (no table)
  g5. PCF 5x5 window: 25 taps from the 1024^2 map (per tap)
  g6. quad-packed bilinear: one 12-float gather per sample
  g7. the lane gather kernel (``kernels/gather.py``) on channel 0

Usage:
    python -m syzygy_tpu_torch.tools.gather_bench [n_samples_millions] [--device cuda|cpu]

On ``cuda`` (the default) times come from CUDA events over 6 calls after
2 warm-up calls, beside the card's name and power limit; ``--device cpu``
runs the same forms and times them on the host clock. Each form prints a
checksum (the float64 sum of its output) so runs can be compared.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from syzygy_tpu_torch.device import as_device
from syzygy_tpu_torch.kernels.gather import lane_gather, lut_index

H, W = 128, 512  # transmittance LUT dims (v, u)
KU, KV = 10, 6  # Chebyshev terms
S3_MAX = 65536  # the one-hot product's sample cap
REPEATS = 6
WARMUP = 2


def sample_count(millions: float) -> int:
    """Samples for ``millions``, rounded down to a multiple of 1024."""
    return int(millions * 1e6) // 1024 * 1024


def bench_inputs(n_samples: int, seed: int = 0) -> dict:
    """The reference bench's seeded inputs, drawn in its order."""
    rng = np.random.default_rng(seed)
    lut = rng.random((H, W, 3), np.float32)
    u = rng.random(n_samples, np.float32)
    v = rng.random(n_samples, np.float32)
    shadow = rng.random((1024, 1024), np.float32)
    coef = rng.random((KU, KV, 3), np.float32) / (KU * KV)
    return {"lut": lut, "u": u, "v": v, "shadow": shadow, "coef": coef}


def quad_table(lut: np.ndarray) -> np.ndarray:
    """(H, W, 3) -> (H*W, 12): each texel's edge-clamped 2x2 footprint."""
    h, w = lut.shape[:2]
    right = np.minimum(np.arange(w) + 1, w - 1)
    down = np.minimum(np.arange(h) + 1, h - 1)
    quad = np.zeros((h, w, 12), np.float32)
    quad[:, :, 0:3] = lut
    quad[:, :, 3:6] = lut[:, right]
    quad[:, :, 6:9] = lut[down]
    quad[:, :, 9:12] = lut[down][:, right]
    return quad.reshape(h * w, 12)


def _coords(lut_hw, u, v):
    h, w = lut_hw
    uu = torch.clamp(u, 0.0, 1.0) * (w - 1)
    vv = torch.clamp(v, 0.0, 1.0) * (h - 1)
    return uu, vv


def g1(lut, u, v):
    h, w = lut.shape[:2]
    uu, vv = _coords((h, w), u, v)
    x0 = torch.floor(uu).to(torch.int32)
    y0 = torch.floor(vv).to(torch.int32)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]
    x0, x1, y0, y1 = (t.long() for t in (x0, x1, y0, y1))
    return (
        lut[y0, x0] * (1 - fx) * (1 - fy)
        + lut[y0, x1] * fx * (1 - fy)
        + lut[y1, x0] * (1 - fx) * fy
        + lut[y1, x1] * fx * fy
    )


def g2(lut, u, v):
    h, w = lut.shape[:2]
    uu, vv = _coords((h, w), u, v)
    idx = torch.round(vv).to(torch.int32) * w + torch.round(uu).to(torch.int32)
    return lut.reshape(-1, 3)[idx.long()]


def g3(lut, u, v):
    """One-hot interpolation: a v-axis (S, H) @ (H, W*3) bf16 product, then
    a u-axis one-hot contraction, as XLA runs it (no kernel)."""
    n_s = u.shape[0]
    h, w = lut.shape[:2]
    uu, vv = _coords((h, w), u, v)
    y0 = torch.floor(vv).to(torch.int32)
    fy = (vv - y0)[..., None]
    iy = torch.arange(h, dtype=torch.int32, device=u.device)[None, :]
    wv = torch.where(iy == y0[:, None], 1.0 - fy, 0.0) + torch.where(
        iy == torch.clamp(y0 + 1, max=h - 1)[:, None], fy, 0.0
    )
    rows = wv.to(torch.bfloat16) @ lut.reshape(h, w * 3).to(torch.bfloat16)
    rows = rows.reshape(n_s, w, 3)
    x0 = torch.floor(uu).to(torch.int32)
    fx = (uu - x0)[..., None]
    ix = torch.arange(w, dtype=torch.int32, device=u.device)[None, :]
    wu = torch.where(ix == x0[:, None], 1.0 - fx, 0.0) + torch.where(
        ix == torch.clamp(x0 + 1, max=w - 1)[:, None], fx, 0.0
    )
    return torch.einsum("sw,swc->sc", wu.to(torch.bfloat16), rows).to(torch.float32)


def g4(coef, u, v):
    x = torch.clamp(u, 0.0, 1.0) * 2.0 - 1.0
    y = torch.clamp(v, 0.0, 1.0) * 2.0 - 1.0

    def cheb(t, k):
        outs = [torch.ones_like(t), t]
        for _ in range(k - 2):
            outs.append(2.0 * t * outs[-1] - outs[-2])
        return torch.stack(outs[:k], dim=-1)

    return torch.einsum("su,sv,uvc->sc", cheb(x, coef.shape[0]), cheb(y, coef.shape[1]), coef)


def g5(shadow, u, v):
    dim = shadow.shape[0]
    uu = torch.clamp(u, 0.0, 1.0) * float(dim - 1)
    vv = torch.clamp(v, 0.0, 1.0) * float(dim - 1)
    x0 = torch.floor(uu).to(torch.int64)
    y0 = torch.floor(vv).to(torch.int64)
    acc = torch.zeros_like(uu)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            acc = acc + shadow[torch.clamp(y0 + dy, 0, dim - 1), torch.clamp(x0 + dx, 0, dim - 1)]
    return acc


def g6(quad, u, v, lut_hw=(H, W)):
    h, w = lut_hw
    uu, vv = _coords((h, w), u, v)
    x0 = torch.floor(uu).to(torch.int32)
    y0 = torch.floor(vv).to(torch.int32)
    fx = (uu - x0)[..., None]
    fy = (vv - y0)[..., None]
    q = quad[(y0 * w + x0).long()]
    top = q[:, 0:3] * (1 - fx) + q[:, 3:6] * fx
    bot = q[:, 6:9] * (1 - fx) + q[:, 9:12] * fx
    return top * (1 - fy) + bot * fy


def g7(flat, u, v, lut_hw=(H, W)):
    return lane_gather(flat, lut_index(u, v, *lut_hw))


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, device) -> tuple[float, torch.Tensor]:
    """Mean ms per call over REPEATS calls after WARMUP calls: CUDA events
    on a GPU, the host clock on the CPU."""
    for _ in range(WARMUP):
        out = fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(REPEATS):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / REPEATS, out
    t0 = time.perf_counter()
    for _ in range(REPEATS):
        out = fn()
    return (time.perf_counter() - t0) * 1000.0 / REPEATS, out


def run(n_samples: int, device) -> dict:
    """Time every form on ``device``; returns per-form ms, ns per sample
    (per tap for g5) and checksum."""
    inputs = bench_inputs(n_samples)
    t = {k: torch.from_numpy(a).to(device) for k, a in inputs.items()}
    quad = torch.from_numpy(quad_table(inputs["lut"])).to(device)
    flat = t["lut"][:, :, 0].contiguous().reshape(-1)
    lut, u, v = t["lut"], t["u"], t["v"]
    s3 = min(n_samples, S3_MAX)
    forms = [
        ("g1 bilinear fancy-index", lambda: g1(lut, u, v), n_samples),
        ("g2 nearest flat gather", lambda: g2(lut, u, v), n_samples),
        ("g3 one-hot bf16 matmul", lambda: g3(lut, u[:s3], v[:s3]), s3),
        ("g4 chebyshev 10x6", lambda: g4(t["coef"], u, v), n_samples),
        ("g5 PCF 25-tap", lambda: g5(t["shadow"], u, v), n_samples * 25),
        ("g6 quad-pack bilinear", lambda: g6(quad, u, v), n_samples),
        ("g7 lane gather kernel", lambda: g7(flat, u, v), n_samples),
    ]
    results = {}
    for name, fn, per in forms:
        ms, out = _time_ms(fn, device)
        results[name.split()[0]] = {
            "name": name, "ms": ms, "ns_per_sample": ms * 1e6 / per,
            "checksum": float(out.double().sum()),
        }
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="LUT-sampling micro-benchmark")
    parser.add_argument("n_samples_millions", type=float, nargs="?", default=2.0)
    parser.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    args = parser.parse_args(argv)
    device = as_device(args.device)
    n_samples = sample_count(args.n_samples_millions)
    if device.type == "cuda":
        print(f"{torch.cuda.get_device_name(device)}; nvidia-smi: {_nvidia_smi()}", flush=True)
        clock = "CUDA events"
    else:
        clock = "host clock, CPU"
    print(f"S = {n_samples} samples on {device} ({clock})", flush=True)
    results = run(n_samples, device)
    for r in results.values():
        print(
            f"  {r['name']:<24}: {r['ms']:9.3f} ms -> {r['ns_per_sample']:8.3f} ns/sample"
            f" (chk {r['checksum']:.9e})",
            flush=True,
        )
    print("gather bench complete", flush=True)
    return {"device": str(device), "samples": n_samples, "forms": results}


if __name__ == "__main__":
    main()
