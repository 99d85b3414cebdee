"""Each cell's whole run at 256x128 on the CPU: the loop, the check
against the plain reference and the result line's keys."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch
from conftest import CELLS, ROOT, SEED, small_cell

from frame_bench.run import result_line

CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "breakdown"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_matches_the_reference(name):
    cell = small_cell(name)
    result = result_line(cell, SEED, 12.0, False, torch.device("cpu"), time.perf_counter())
    line = json.dumps(result)
    assert set(json.loads(line)) <= CONTRACT_KEYS | {"check"}
    assert list(result)[-1] == "check"  # the compared numbers come last
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 1
    assert set(result["metrics"]) <= {m["name"] for m in cell.end_to_end}
    assert {"frame_ms", "setup_s"} <= set(result["metrics"])
    for c in result["check"].values():
        assert c["value"] <= c["limit"]
    # the port's CPU frame and the plain reference agree bitwise here
    assert result["check"]["rmse"]["value"] == 0.0


def test_without_a_gpu_no_result_and_a_nonzero_exit():
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "frame_bench", "run.py"), "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""},
        timeout=120,
    )
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
