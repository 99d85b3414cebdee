"""The benchmark is driven by data: a configuration, a traffic mix, a
metric and a check added as new files (and entries in BENCHMARK.json)
to a copy of the checkout are found and run, no existing file of
``frame_bench/`` edited."""

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, SMALL


def test_a_new_config_traffic_and_metric_are_found_and_run(tmp_path):
    dst = tmp_path / "checkout"
    bench = dst / "frame_bench"
    shutil.copytree(os.path.join(ROOT, "frame_bench"), bench, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    config = json.loads((bench / "configs" / "editor-default.json").read_text())
    config.update(name="tiny-editor", sun={"time": 0.5, "speed": 0.0, "frozen": True})
    config["render"].update(SMALL)
    (bench / "configs" / "tiny-editor.json").write_text(json.dumps(config))
    (bench / "traffic" / "tiny-orbit.json").write_text(json.dumps({
        "in_flight": 1, "dt_s": 0.5, "orbit_deg_per_s": 90.0, "check_frames": 1,
        "trace_after_frames": 1, "trace_frames": 1,
    }))
    (bench / "metrics" / "frames_counted.py").write_text(
        "def read(run):\n    return float(len(run.counted))\n"
    )
    (bench / "checks" / "tiny-editor.tiny-orbit.json").write_text(json.dumps({"rmse": 1e-6}))
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-editor", "source": "test", "file": "frame_bench/configs/tiny-editor.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-editor.tiny-orbit", "config": "tiny-editor", "traffic": "tiny-orbit",
                              "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "frames_counted", "unit": "frames", "better": "higher", "bound": 0.25,
                               "source": "host_clock", "workloads": ["tiny-editor.tiny-orbit"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    assert all(p.read_bytes() == data for p, data in before.items())  # nothing edited

    script = f"""
import json, sys, time, torch
sys.path[:0] = [{str(dst)!r}, {ROOT!r}]
torch.set_num_threads(4)
import frame_bench.harness as h
assert h.__file__.startswith({str(dst)!r}), h.__file__
from frame_bench.run import result_line
cell = h.load_cell("tiny-editor.tiny-orbit")
print(json.dumps(result_line(cell, 11, 8.0, False, torch.device("cpu"), time.perf_counter())))
"""
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames_counted"]["value"] >= 1.0
    assert list(result["check"]) == ["frames", "rmse"]
