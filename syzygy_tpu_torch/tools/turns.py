"""The parent commit against this checkout on one card, in turns.

    python -m syzygy_tpu_torch.tools.turns PARENT_DIR

``PARENT_DIR`` is the parent commit unpacked (``git archive``) into a
git-ignored directory of this checkout, so that it travels to the card
with it. Each run is a process of its own, started from the root of its
checkout, in the order parent, change, change, parent:

1. ``python -m syzygy_tpu_torch.bench`` (its JSON line);
2. the viewer's request timing of that checkout's ``chip_smoke.py``
   (``_pipeline_saving``: host ms per request after an input, two frames
   in flight against one, the chess flagship at 1920x1080, 5 rounds);

then ``python -m syzygy_tpu_torch.profile --scene default`` and
``--scene dense`` once per checkout. It prints the card's name and power
limit, then one line per run: the checkout, the run, its exit code and
seconds, and its last line of output (stderr's tail where it failed).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT = 900  # s per run
VIEWER_ROUNDS = 5


def viewer_timing(root: str) -> dict:
    """``chip_smoke._pipeline_saving`` of the checkout at ``root``, with
    that checkout's package."""
    import torch

    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_of_root", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    scene, library = smoke.flagship()
    config = smoke.default_scene_config(scene, library, width=1920, height=1080)
    return smoke._pipeline_saving(*smoke.flagship(), config, torch.device("cuda", 0), rounds=VIEWER_ROUNDS)


def _run(label: str, what: str, cmd: list, cwd: str) -> None:
    t0 = time.time()
    done = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True, timeout=TIMEOUT)
    lines = done.stdout.strip().splitlines()
    print(f"{label} {what} rc={done.returncode} {time.time() - t0:.1f}s: {lines[-1] if lines else ''}", flush=True)
    if done.returncode:
        print(done.stderr[-3000:], flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("parent", help="the parent commit, unpacked")
    parser.add_argument("--viewer", metavar="ROOT", help=argparse.SUPPRESS)  # one viewer run, in its own process
    args = parser.parse_args(argv)
    if args.viewer:
        print("viewer " + json.dumps(viewer_timing(os.path.abspath(args.viewer))))
        return 0
    parent = os.path.abspath(args.parent)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True,
    )
    print(smi.stdout.strip(), flush=True)
    turns = [("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)]
    for label, root in turns:
        _run(label, "bench", [sys.executable, "-m", "syzygy_tpu_torch.bench"], root)
    for label, root in turns:
        # by path, from the checkout's root: the run imports that checkout's package alone
        _run(label, "viewer", [sys.executable, os.path.abspath(__file__), parent, "--viewer", root], root)
    for label, root in (("change", ROOT), ("parent", parent)):
        for scene in ("default", "dense"):
            _run(label, f"profile {scene}", [sys.executable, "-m", "syzygy_tpu_torch.profile", "--scene", scene], root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
