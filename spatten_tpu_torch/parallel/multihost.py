"""Multi-process runtime: initialization and the health probe (port of
``spatten_tpu/parallel/multihost.py``).

* ``initialize(...)`` -- one call per process before any collective:
  ``torch.distributed.init_process_group`` over NCCL where CUDA is present,
  else gloo.  Nothing on a card's machine announces a cluster, so a
  caller names the rendezvous (``tcp://host:port``), the world size and
  its rank, or sets ``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
  ``RANK`` for ``env://``.
* ``health_check(...)`` -- an all-reduce heartbeat over the process group
  (or, without one, a one-element add on the local device) that reports a
  dead or hung peer as False within a timeout instead of a silent stall in
  the decode loop; ``engine.supervisor.generate_supervised`` probes with it
  before every window and restores its latest snapshot on False.
"""

from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (nothing if one already exists).

    ``coordinator_address``: ``tcp://host:port`` (a bare ``host:port`` is
    read as tcp), or None for ``env://``.  The backend is ``backend``, by
    default NCCL where CUDA is available (each rank then uses card ``rank
    % device_count``), else gloo; gloo on a card's machine lets several
    ranks share one card (their collectives run through the host)."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    if backend == "nccl":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())


def _probe() -> bool:
    if dist.is_available() and dist.is_initialized():
        nccl = dist.get_backend() == "nccl"
        dev = (torch.device("cuda", torch.cuda.current_device()) if nccl
               else torch.device("cpu"))
        x = torch.ones((1,), dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        return float(x.item()) == float(dist.get_world_size())
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    x = torch.ones((1,), dtype=torch.float32, device=dev) + 1.0
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return float(x.item()) == 2.0


def health_check(timeout_s: float = 60.0) -> bool:
    """Heartbeat: True if every process of the group took part in an
    all-reduce of ones (or, with no group, the local device ran a
    one-element add) within ``timeout_s`` seconds.

    The probe runs in a worker thread joined with the timeout: a missing
    or hung peer either raises inside the collective or never completes,
    and both report False so that the caller can recover (restart from a
    snapshot, ``engine/checkpoint.py``)."""
    result: list = []

    def run():
        try:
            result.append(_probe())
        except Exception:                     # collective/runtime failure
            result.append(False)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result and result[0])
