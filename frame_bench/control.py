"""Readings of the check on many seeds in one process, for setting limits.

    python3 frame_bench/control.py --workload <cell> --seeds 1,2,3 --seconds 4 \
        [--set lut_f16=true --set pcf_q8=true]

Runs the cell's set-up and a short window per seed, as ``run.py`` does,
and compares the window's kept frames with the plain reference; prints
one JSON line per seed with the per-frame readings. ``--set`` switches the
program's own lower-precision paths on (``RenderConfig`` fields): the
control, which the limits have to fail. The benchmark's runs never run
this; its readings and the limits set from them are in ``PERF.md``.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _value(text: str):
    return json.loads(text.lower()) if text.lower() in ("true", "false") else json.loads(text)


def readings(cell, seeds, seconds: float, device, overrides: dict) -> list:
    """[(seed, {frame: {number: reading}}), ...] of the program run with
    ``overrides``, checked against the reference as the cell states it."""
    import torch

    from frame_bench.check import check_run
    from frame_bench.harness import run_cell
    from syzygy_tpu_torch.renderer import frame

    out = []
    for seed in seeds:
        run = run_cell(cell, seed, seconds, False, device, time.perf_counter(), render_overrides=overrides)
        _, _, per_frame, _ = check_run(run, device)
        out.append((seed, per_frame))
        del run
        frame._GRAPHS.clear()  # this seed's captured frame and its pool
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=4.0)
    parser.add_argument("--set", action="append", default=[], help="RenderConfig field=value of the program")
    args = parser.parse_args(argv)

    import torch

    from frame_bench.harness import load_cell

    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    overrides = {k: _value(v) for k, v in (s.split("=", 1) for s in args.set)}
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    for seed, per_frame in readings(cell, seeds, args.seconds, torch.device("cuda", 0), overrides):
        print(json.dumps({"workload": args.workload, "set": overrides, "seed": seed, "readings": per_frame}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
