"""Run one function on every rank of a fresh ``torch.distributed`` group.

:func:`run` starts ``world_size`` processes of ``python -m
syzygy_tpu_torch.parallel.ranks``, one per rank, that meet through a file
store in a temporary directory, call ``module:function(**kwargs)`` and
hand back its return value (``torch.save``: tensors, numpy arrays and
plain values). A rank that fails, and a run that outlives ``timeout``,
ends every rank and raises. The ranks import only what the function's
module imports.

Backend: ``gloo`` on the CPU; on CUDA, ``nccl`` when every rank has a
card of its own and ``gloo`` when ranks share one (NCCL refuses two ranks
on one GPU; gloo takes CUDA tensors through host memory).
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def backend_for(device_type: str, world_size: int) -> str:
    import torch

    if device_type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def run(world_size: int, target: str, kwargs: dict | None = None, *, device: str,
        timeout: float = 300.0, threads: int = 1) -> list:
    """Every rank's return value of ``target`` ("module:function"), in rank
    order. ``device`` is ``cpu`` or ``cuda`` (rank r on card r % count);
    ``threads`` is each rank's torch thread count. Raises RuntimeError
    when a rank fails and TimeoutError after ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="szg_ranks_") as tmp:
        spec = {
            "world_size": world_size, "target": target, "kwargs": kwargs or {}, "device": device,
            "backend": backend_for(device, world_size), "store": os.path.join(tmp, "store"),
            "timeout": timeout, "threads": threads, "out": os.path.join(tmp, "result"),
        }
        spec_path = os.path.join(tmp, "spec.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [_ROOT, os.environ.get("PYTHONPATH")])))
        procs, logs = [], []
        try:
            for rank in range(world_size):
                log = open(os.path.join(tmp, f"log.{rank}"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "syzygy_tpu_torch.parallel.ranks", spec_path, str(rank)],
                    stdout=log, stderr=subprocess.STDOUT, env=env, cwd=tmp,
                ))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} of {world_size} failed:\n{_tail(logs[failed[0]])}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{target} on {world_size} ranks did not finish in {timeout} s:\n{_tail(logs[0])}")
                time.sleep(0.05)
            failed = [r for r, p in enumerate(procs) if p.returncode != 0]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {world_size} failed:\n{_tail(logs[failed[0]])}")
            import torch

            return [torch.load(f"{spec['out']}.{rank}", weights_only=False) for rank in range(world_size)]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()


def _tail(log, n: int = 4000) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-n:]


def _rank_main(spec_path: str, rank: int) -> None:
    import torch
    import torch.distributed as dist

    with open(spec_path) as f:
        spec = json.load(f)
    torch.set_num_threads(spec["threads"])
    if spec["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    dist.init_process_group(
        spec["backend"], init_method=f"file://{spec['store']}", world_size=spec["world_size"], rank=rank,
        timeout=datetime.timedelta(seconds=spec["timeout"]),
    )
    try:
        result = fn(**spec["kwargs"])
        torch.save(result, f"{spec['out']}.{rank}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]))
