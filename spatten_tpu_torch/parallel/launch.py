"""Run a function in N processes joined in one process group, and collect
what each returns.

``spawn("module:function", world, *args)`` starts ``world`` Python
processes at once; rank r joins the group through a free TCP port on
localhost (``multihost.initialize``), calls ``function(rank, world,
*args)`` and writes its return value (pickled) to a temporary file, which
the caller reads back, rank by rank.  A rank that raises, exits or
outlives ``timeout`` seconds fails the whole run: every process is
stopped and the failing rank's output is raised with a RuntimeError.  The
function is imported by name in each process, so its module must be
importable there (``path`` adds directories to the children's
``sys.path``) and cheap to import.

The backend is the caller's: under gloo the ranks run on the CPU, or
share one card (the function puts its tensors on card 0: its kernels and
matmuls run there, its collectives through the host); NCCL needs one card
per rank.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Sequence

_REPO = Path(__file__).resolve().parents[2]

_CHILD = """
import importlib, pickle, sys
sys.path[:0] = {path!r}
target, rank, world, port, backend, args_file, out_file = sys.argv[1:8]
rank, world = int(rank), int(world)
import torch
if backend == "gloo":
    torch.set_num_threads({threads})
from spatten_tpu_torch.parallel import multihost
multihost.initialize(f"tcp://127.0.0.1:{{port}}", world, rank,
                     backend=backend)
module, name = target.split(":")
fn = getattr(importlib.import_module(module), name)
with open(args_file, "rb") as fh:
    args = pickle.load(fh)
out = fn(rank, world, *args)
with open(out_file, "wb") as fh:
    pickle.dump(out, fh)
torch.distributed.barrier()
torch.distributed.destroy_process_group()
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, *args, timeout: float = 600.0,
          backend: str = "gloo", path: Sequence[str] = (),
          threads: int = 1) -> list:
    """Run ``target`` ("module:function") as ranks 0..world-1 of one
    process group and return their results in rank order."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        args_file = os.path.join(tmp, "args.pkl")
        with open(args_file, "wb") as fh:
            pickle.dump(args, fh)
        code = _CHILD.format(path=[str(_REPO), *map(str, path)],
                             threads=threads)
        child_env = dict(os.environ, OMP_NUM_THREADS=str(threads))
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, target, str(r), str(world),
                 str(port), backend, args_file,
                 os.path.join(tmp, f"out{r}.pkl")],
                stdout=log, stderr=subprocess.STDOUT, env=child_env))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad or time.monotonic() > deadline:
                    r = bad[0] if bad else None
                    _stop(procs)
                    raise RuntimeError(_report(
                        f"rank {r} failed" if bad else
                        f"ranks outlived {timeout:.0f} s", logs, r))
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            if bad:
                raise RuntimeError(_report(f"rank {bad[0]} failed", logs,
                                           bad[0]))
            out = []
            for r in range(world):
                with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as fh:
                    out.append(pickle.load(fh))
            return out
        finally:
            _stop(procs)
            for log in logs:
                log.close()


def _stop(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


def _report(what: str, logs, rank) -> str:
    text = []
    for r, log in enumerate(logs):
        if rank is not None and r != rank:
            continue
        log.flush()
        log.seek(0)
        text.append(f"--- rank {r}:\n{log.read()[-6000:]}")
    return f"{what}\n" + "\n".join(text)
