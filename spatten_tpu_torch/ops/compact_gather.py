"""Prune-event row compaction of the int8 K and V planes (kernel K2).

Replaces the TPU kernel ``spatten_tpu/ops/compact_gather.py::
gather_compact_rows`` (``pl.pallas_call`` at :335).  For each (sequence,
kv head), rows ``keep_idx[b, h, :keep_count[b]]`` (ascending, distinct) of
both planes move to the front of that head's lanes, in place.
Untriggered sequences and rows at or past ``keep_count`` are untouched.

Beside the CUDA kernel (``csrc/compact_gather.cu``, whose header says
what bounds it on the card and how its design handles that) lives its
plain PyTorch version, ``gather_compact_rows_plain``.  The wrapper runs
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  ``gather_compact_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatten_tpu_torch import kernels
from spatten_tpu_torch.utils.profiling import tracer


def _check(k_plane, v_plane, keep_idx, lengths, triggered, keep_count):
    if k_plane.dim() != 3 or k_plane.shape != v_plane.shape:
        raise ValueError("k_plane and v_plane must both be [B, C, H*D]")
    b, c, f = k_plane.shape
    if keep_idx.dim() != 3 or keep_idx.shape[0] != b or f % keep_idx.shape[1]:
        raise ValueError(f"keep_idx {tuple(keep_idx.shape)} does not match "
                         f"planes {tuple(k_plane.shape)}")
    if keep_idx.shape[2] > c:
        raise ValueError("more keep entries than capacity")
    for name, t in (("lengths", lengths), ("triggered", triggered),
                    ("keep_count", keep_count)):
        if t is not None and t.shape != (b,):
            raise ValueError(f"{name} must be [B]")


def k2_takes(head_dim: int) -> bool:
    """Whether K2 on the card takes rows of ``head_dim`` int8 values (it
    moves them as 16-byte vectors).  The prune compaction sends other
    shapes to its gather path, as the JAX gate does."""
    return head_dim % 16 == 0


def gather_compact_rows_plain(
    k_plane: torch.Tensor, v_plane: torch.Tensor, keep_idx: torch.Tensor,
    lengths: torch.Tensor, triggered: torch.Tensor, *,
    keep_count: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: same function, same in-place
    contract (the planes are consumed and returned)."""
    del lengths, window       # keep indices already lie below both
    b, c, f = k_plane.shape
    h, p = keep_idx.shape[1:]
    d = f // h
    dev = k_plane.device
    kc = (torch.full((b,), p, device=dev) if keep_count is None
          else keep_count)
    slot = torch.arange(p, device=dev)
    live = (slot[None, None, :] < kc[:, None, None]) \
        & triggered.to(torch.bool)[:, None, None]                   # [B,H,P]
    src = torch.where(live, keep_idx.to(torch.int64), slot)      # identity
    src = src.transpose(1, 2)[..., None].expand(b, p, h, d)
    for plane in (k_plane, v_plane):
        rows = plane.view(b, c, h, d)
        rows[:, :p] = torch.gather(rows, 1, src)
    return k_plane, v_plane


def gather_compact_rows(
    k_plane: torch.Tensor,      # [B, C, H*D] int8 token-major (one layer)
    v_plane: torch.Tensor,      # [B, C, H*D] int8
    keep_idx: torch.Tensor,     # [B, H, P] int32; first keep_count entries
                                #   ascending + distinct, the rest dead
    lengths: torch.Tensor,      # [B] int32 live tokens
    triggered: torch.Tensor,    # [B] bool/int; False rows are untouched
    *,
    keep_count: Optional[torch.Tensor] = None,   # [B] live keep entries
    window: Optional[int] = None,                # static bound on lengths
) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact kept rows to the front of both planes IN PLACE (the planes
    are consumed and returned)."""
    _check(k_plane, v_plane, keep_idx, lengths, triggered, keep_count)
    if not k_plane.is_cuda:
        return gather_compact_rows_plain(
            k_plane, v_plane, keep_idx, lengths, triggered,
            keep_count=keep_count, window=window)
    with tracer.span("k2.launch"):
        b, c, f = k_plane.shape
        h, p = keep_idx.shape[1:]
        d = f // h
        dev = k_plane.device
        if k_plane.dtype != torch.int8 or v_plane.dtype != torch.int8:
            raise TypeError("K2 takes int8 planes")
        if not (k_plane.is_contiguous() and v_plane.is_contiguous()):
            raise ValueError("K2 takes contiguous planes")
        if not k2_takes(d):
            raise NotImplementedError(f"K2 needs head_dim % 16 == 0, got {d}")
        for t in (v_plane, keep_idx, triggered):
            if t.device != dev:
                raise ValueError("K2 operands must share one CUDA device")
        idx = keep_idx.to(torch.int32).contiguous()
        kc = (torch.full((b,), p, dtype=torch.int32, device=dev)
              if keep_count is None
              else keep_count.to(torch.int32).contiguous())
        trig = triggered.to(torch.int32).contiguous()
        kernels.launch("compact_gather", k_plane, v_plane, idx, kc, trig,
                       b, c, h, d, p)
    gather_compact_rows.launches += 1
    return k_plane, v_plane


gather_compact_rows.launches = 0
