"""Run a function in several fresh processes joined by torch.distributed:
the port's stand-in for a launcher, for the tests and the card's smoke
(training itself launches with torchrun).

    results = spawn("package.module:function", 4, arg, backend="gloo")

calls function(*args) in 4 processes, `python -m
thyroid_tpu_torch.parallel.spawn`, each its rank of a process group that
rendezvouses through a file in a fresh temporary directory (never a fixed
port, so that runs side by side do not meet), with RANK, WORLD_SIZE and
LOCAL_RANK set as torchrun sets them; → each rank's return value, in rank
order. A rank that fails stops every other and raises its error's last
lines; so does the time limit. The gloo backend reduces CUDA tensors
through the host, so two ranks may share one card; NCCL refuses that.
"""
from __future__ import annotations

import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional

import torch

ROOT = Path(__file__).resolve().parents[2]


def spawn(target: str, nprocs: int, *args: Any, backend: str = "gloo",
          timeout: float = 600.0, threads: Optional[int] = None) -> List[Any]:
    """`target` is "module:function"; `args` go to it pickled (torch.save),
    and its return values come back the same way. `threads` sets each
    rank's torch intra-op threads."""
    with tempfile.TemporaryDirectory(prefix="spawn-") as tmp:
        work = Path(tmp)
        torch.save({"target": target, "args": args, "backend": backend,
                    "threads": threads}, work / "job.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT), os.getcwd()] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
        procs, logs = [], []
        try:
            for rank in range(nprocs):
                log = open(work / f"rank{rank}.log", "wb")
                logs.append(log)
                env_r = dict(env, RANK=str(rank), WORLD_SIZE=str(nprocs),
                             LOCAL_RANK=str(rank))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "thyroid_tpu_torch.parallel.spawn",
                     str(work)], env=env_r, stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        codes = [p.returncode for p in procs]
        if any(codes):
            rank = next((r for r, c in enumerate(codes) if c not in (0, -9)), 0)
            tail = (work / f"rank{rank}.log").read_bytes()[-4000:].decode(
                errors="replace")
            raise RuntimeError(f"spawn {target}: exit codes {codes} "
                               f"(a rank failed or the {timeout:.0f} s limit "
                               f"passed); rank {rank}'s last output:\n{tail}")
        return [torch.load(work / f"result{r}.pt", weights_only=False)
                for r in range(nprocs)]


def _child(work: Path) -> None:
    import torch.distributed as dist

    job = torch.load(work / "job.pt", weights_only=False)
    if job["threads"]:
        torch.set_num_threads(int(job["threads"]))
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(job["backend"], init_method=f"file://{work}/rendezvous",
                            rank=rank, world_size=world)
    try:
        module, _, name = job["target"].partition(":")
        result = getattr(importlib.import_module(module), name)(*job["args"])
        torch.save(result, work / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(Path(sys.argv[1]))
