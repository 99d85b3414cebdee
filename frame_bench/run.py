"""Run one cell of the port's benchmark on this machine's GPU.

    python3 frame_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (:mod:`frame_bench.harness`),
builds and warms up the port's frame for it, measures for ``--seconds``,
compares the window's kept images with the plain reference
(:mod:`frame_bench.check`) and prints one JSON line as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``check``, each compared number beside its limit (also the last lines of
standard error). Without a CUDA device, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")
# every build and kernel cache at a fixed path inside the checkout (the port
# builds its CUDA kernels into its own syzygy_tpu_torch/_build/)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = os.path.join(CACHE, sub)
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "syzygy_tpu")  # top-level module names, compared whole


def forbidden_modules() -> list:
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def read_metrics(run, metrics: list) -> dict:
    """Each metric's reader (``metrics/<name>.py``); a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = importlib.import_module(f"frame_bench.metrics.{m['name']}").read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def result_line(cell, seed: int, seconds: float, trace: bool, device, t_start: float, render=None) -> dict | None:
    """One run of ``cell`` on ``device``: set-up, window, check, metrics.
    Returns the result line's object, or None (with the reason on
    standard error) when JAX or the JAX package was loaded. ``render``
    stands in for the port's frame entry (tests plant faults with it)."""
    import torch

    from frame_bench.check import check_run
    from frame_bench.harness import run_cell

    run = run_cell(cell, seed, seconds, trace, device, t_start, render=render)
    traced = run.trace.frames if run.trace is not None else ()
    t_check = time.perf_counter()
    correct, checks, readings, work = check_run(run, device, traced)
    run.roofline = work if traced else None
    done = sorted(f.t_done for f in run.counted)
    gaps = sorted((b - a) * 1e3 for a, b in zip(done, done[1:]))
    if gaps:
        print(f"ms between images: min {gaps[0]:.2f}, median {gaps[len(gaps) // 2]:.2f}, max {gaps[-1]:.2f}; "
              f"first five {[round((b - a) * 1e3, 2) for a, b in zip(done[:5], done[1:6])]}", file=sys.stderr)
        spans = {(n, k): (t1 - t0) * 1e3 for n, k, t0, t1 in run.spans.records}
        latency = {f.k: (f.t_done - f.t_input) * 1e3 for f in run.counted}
        typical = sorted(latency.values())[len(latency) // 2]
        slow = [(k, round(ms, 2), *(round(spans.get((n, k), 0.0), 2) for n in ("pack", "issue", "fetch_wait")))
                for k, ms in latency.items() if ms > 1.05 * typical][:20]
        print(f"frames over 1.05 x the median latency {typical:.2f} ms (k, ms, pack, issue, fetch_wait; "
              f"the first 20): {slow}",
              file=sys.stderr)
    print(f"setup {run.setup_s:.3f} s, window {run.window_s:.3f} s over {len(run.counted)} of "
          f"{len(run.frames)} frames, check {time.perf_counter() - t_check:.3f} s; "
          f"readings {json.dumps(readings)}; set-up stages (s from start) {json.dumps(run.setup_stages)}",
          file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package is loaded: {', '.join(bad)}", file=sys.stderr)
        return None
    cuda = device.type == "cuda"
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(cell.workload["chips"]),
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    result = {
        "correct": correct,
        "attempted": len(run.frames),
        "failed": sum(
            1 for r in readings.values() if any(not r[n] <= limit for n, limit in cell.limits.items())
        ) + max(0, checks["frames"]["limit"] - len(readings)),
        "metrics": read_metrics(run, cell.per_layer if trace else cell.end_to_end),
        "device": device_info,
    }
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["check"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from frame_bench.harness import load_cell

    cell = load_cell(args.workload)
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = result_line(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    if result is None:
        return 3
    for name, c in result["check"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
