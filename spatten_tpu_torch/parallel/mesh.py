"""A rank's place on a mesh of processes, and the one transport the
multi-card engines use (port of ``spatten_tpu/parallel/mesh.py``).

JAX runs one controller over a device mesh and reduces with ``lax.psum``
inside ``shard_map``; PyTorch runs one process per shard.  ``make_mesh``
lays the ranks of the current process group out on a grid of
``MeshConfig``'s two axes (``("data", "model")`` for ``ShardedEngine``,
``("pipe", "model")`` for ``PipelineEngine``), row-major as JAX reshapes
its device list, and makes one sub-group (``dist.new_group``) for each
axis and one for the whole mesh.

The transport: ``all_reduce`` (a ``lax.psum``) and ``send`` / ``recv``
(a stage hand-off, JAX's ``ppermute``).  Which way a tensor travels is
chosen by the group's backend, never by catching an error: under NCCL the
tensor stays on its device; under gloo a CUDA tensor is copied to the
host, reduced or sent there, and copied back (gloo's CUDA support is
partial: its send and recv take CPU tensors only, and bf16 on its CUDA
all-reduce is not assured).  gloo's ring all-reduce computes each element
on one rank and hands the sum on, so every rank of a group holds the same
bits, as the replicated activations of tensor parallelism need.

Each transport function counts its calls (``.calls``) and, on the host
path, the host seconds they take (``.seconds``: from after the device
work queued before the call, which the copy to the host waits for, to the
copy back), so that a run can say what its collectives cost.  Under NCCL
the call only enqueues, and ``.seconds`` stays 0; after
``reset_counts(events=True)`` each device-path call records a pair of
CUDA events on the current stream around the collective, and
``device_seconds(fn)`` sums them (the collective's time on the device,
waiting for its peers included).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from spatten_tpu_torch.config import MeshConfig
from spatten_tpu_torch.device import resolve_device


@dataclasses.dataclass
class Mesh:
    """One rank's view of a mesh: the axes and their sizes (in order, as
    JAX's ``mesh.shape``), its coordinates (None on a rank past the mesh,
    which takes part in no step), the sub-group of each axis and of the
    whole mesh (``group(...)``), and the device its tensors live on.  A
    mesh built by hand without groups (a position only) serves the
    slicing functions of ``sharded`` and ``convert``."""

    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    coords: Optional[Dict[str, int]]
    device: torch.device = torch.device("cpu")
    groups: Dict[Tuple[str, ...], object] = dataclasses.field(
        default_factory=dict)

    def group(self, *axes: str):
        """The process group over ``axes`` (in the mesh's order): the ranks
        that share this rank's coordinates on every other axis."""
        key = tuple(a for a in self.axis_names if a in axes)
        if len(key) != len(axes):
            raise ValueError(f"axes {axes} are not all of {self.axis_names}")
        return self.groups[key]


def _axis_groups(names, sizes, rank_of):
    """Every sub-grid along each non-empty subset of axes: (axes, ranks)
    in one fixed order, the same on every rank."""
    out = []
    n = len(names)
    for mask in range(1, 1 << n):
        axes = tuple(names[i] for i in range(n) if mask >> i & 1)
        fixed = [i for i in range(n) if not mask >> i & 1]
        free = [i for i in range(n) if mask >> i & 1]

        def walk(idx, dims):
            if not dims:
                yield dict(idx)
                return
            for v in range(sizes[dims[0]]):
                idx[dims[0]] = v
                yield from walk(idx, dims[1:])

        for base in walk({}, fixed):
            ranks = [rank_of({**base, **c}) for c in walk({}, free)]
            out.append((axes, base, sorted(ranks)))
    return out


def make_mesh(cfg: MeshConfig, device: str | torch.device | None = None
              ) -> Mesh:
    """Lay the current process group's ranks out on a (cfg.data,
    cfg.model) grid named ``cfg.axis_names``, rank r at (r // model,
    r % model) as JAX's reshape of its device list, and make each axis's
    sub-group.  Every rank of the group must call it (group creation is
    collective).  Raises, as JAX does, when the world is smaller than
    data x model; ranks past the mesh get ``coords`` None.

    ``device``: where this rank's tensors live (default: the current CUDA
    device, which under NCCL is card ``rank % device_count``; it raises
    without CUDA, so a run on the CPU asks for ``device="cpu"``).  Under
    gloo the ranks may share one card: their kernels and matmuls run
    there, their collectives through the host."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group "
                           "(parallel.multihost.initialize)")
    names = tuple(cfg.axis_names)
    dims = (cfg.data, cfg.model)
    world = dist.get_world_size()
    n = dims[0] * dims[1]
    if world < n:
        raise ValueError(f"mesh {cfg.data}x{cfg.model} needs {n} devices, "
                         f"have {world}")
    rank = dist.get_rank()
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else "cuda"
    device = resolve_device(device)

    def rank_of(c):
        return c[0] * dims[1] + c[1]

    groups, coords = {}, None
    if rank < n:
        coords = {names[0]: rank // dims[1], names[1]: rank % dims[1]}
    for axes, base, ranks in _axis_groups(names, dims, rank_of):
        g = dist.new_group(ranks)
        if coords is not None and all(
                coords[names[i]] == v for i, v in base.items()):
            groups[axes] = g
    return Mesh(axis_names=names, shape=dict(zip(names, dims)),
                coords=coords, device=device, groups=groups)


def _via_host(t: torch.Tensor, group) -> bool:
    """Whether ``t`` travels through host memory in ``group``: a CUDA
    tensor under gloo."""
    return t.is_cuda and dist.get_backend(group) != "nccl"


@contextlib.contextmanager
def _on_device(fn, t: torch.Tensor):
    """Around a device-path collective on ``t``: a pair of CUDA events on
    the current stream when ``fn`` records them (``reset_counts(events=
    True)``)."""
    if fn.events is None or not t.is_cuda:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    fn.events.append((start, end))


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place and return it (``lax.psum``); a
    group of one rank (or None) leaves it as it is."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    all_reduce.calls += 1
    if _via_host(t, group):
        torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        host = t.cpu()
        dist.all_reduce(host, group=group)
        t.copy_(host)
        all_reduce.seconds += time.perf_counter() - t0
    else:
        with _on_device(all_reduce, t):
            dist.all_reduce(t, group=group)
    return t


def send(t: torch.Tensor, dst: int, group) -> None:
    """Hand ``t`` to rank ``dst`` of ``group`` (its index in the group)."""
    peer = dist.get_global_rank(group, dst)
    send.calls += 1
    if _via_host(t, group):
        torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        dist.send(t.cpu(), peer, group=group)
        send.seconds += time.perf_counter() - t0
    else:
        with _on_device(send, t):
            dist.send(t.contiguous(), peer, group=group)


def recv(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """Receive into ``t`` from rank ``src`` of ``group`` and return it."""
    peer = dist.get_global_rank(group, src)
    recv.calls += 1
    if _via_host(t, group):
        torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        host = torch.empty(t.shape, dtype=t.dtype)
        dist.recv(host, peer, group=group)
        t.copy_(host)
        recv.seconds += time.perf_counter() - t0
    else:
        with _on_device(recv, t):
            dist.recv(t, peer, group=group)
    return t


def reset_counts(events: bool = False) -> None:
    """Set the transport's call counts and seconds to 0; with ``events``,
    record CUDA events around each device-path call from now on (else
    none)."""
    for fn in (all_reduce, send, recv):
        fn.calls, fn.seconds = 0, 0.0
        fn.events = [] if events else None


def device_seconds(fn) -> float:
    """The device seconds of ``fn``'s (``all_reduce``, ``send`` or
    ``recv``) recorded calls since ``reset_counts(events=True)``; waits
    for their end events."""
    total = 0.0
    for start, end in fn.events or ():
        end.synchronize()
        total += start.elapsed_time(end) / 1e3
    return total


reset_counts()
