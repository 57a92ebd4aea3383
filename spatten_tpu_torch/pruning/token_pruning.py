"""Cascade KV token pruning: the start/important/recent rolling cache.

Port of ``spatten_tpu/pruning/token_pruning.py``.  A prune keeps the
first ``start`` sink tokens, the per-head top-``important`` tokens by
accumulated importance from the middle region, and the trailing
``recent`` window, in ascending (chronological) order.

``jax.lax.top_k`` breaks ties toward the lower index, and never-attended
tokens all tie at importance 0, so the selection here sorts with
``torch.sort(descending=True, stable=True)``, which keeps that order;
``torch.topk`` promises none.
"""

from __future__ import annotations

import torch

from spatten_tpu_torch.config import PruningConfig
from spatten_tpu_torch.device import resolve_device

_NEG_INF = float("-inf")


def pruned_length(cfg: PruningConfig, num_coming: int) -> int:
    """Number of tokens kept after a prune."""
    recent_keep = cfg.recent_size - num_coming
    if recent_keep < 0:
        raise ValueError(
            f"num_coming={num_coming} exceeds recent_size={cfg.recent_size}")
    return cfg.start_size + cfg.important_size + recent_keep


def select_keep_indices(
    importance: torch.Tensor,       # [..., C]
    length,                         # int, or int tensor broadcastable to [...]
    start_size: int,
    important_size: int,
    recent_size: int,
    num_coming: int,
) -> torch.Tensor:
    """Kept token indices, ascending: int32 [..., keep_total] with
    keep_total = start + important + (recent - num_coming).

    Entries of ``importance`` at or past ``length`` are ignored.  The
    result is meaningful when ``length + num_coming`` exceeds the cache
    size; callers gate on that.  The top-``important`` selection of the
    middle region breaks ties toward the lower index, as
    ``jax.lax.top_k`` does.
    """
    capacity = importance.shape[-1]
    lead = importance.shape[:-1]
    dev = importance.device
    recent_keep = recent_size - num_coming
    if recent_keep < 0:
        raise ValueError(
            f"num_coming={num_coming} exceeds recent_size={recent_size}")
    keep_total = start_size + important_size + recent_keep
    if keep_total > capacity:
        raise ValueError(f"keep {keep_total} exceeds capacity {capacity}")
    pos = torch.arange(capacity, device=dev)
    length = torch.as_tensor(length, dtype=torch.int64, device=dev
                             ).broadcast_to(lead)
    recent_begin = length - recent_keep                        # [...]
    parts = [torch.arange(start_size, device=dev).expand(lead + (start_size,))]
    if important_size > 0:
        in_middle = (pos >= start_size) & (pos < recent_begin[..., None])
        masked = torch.where(in_middle, importance.to(torch.float32),
                             _NEG_INF)
        idx = torch.sort(masked, dim=-1, descending=True, stable=True
                         ).indices[..., :important_size]
        parts.append(torch.sort(idx, dim=-1).values)
    parts.append(recent_begin[..., None]
                 + torch.arange(recent_keep, device=dev))
    return torch.cat(parts, dim=-1).to(torch.int32)


def layer_budgets_static(cfg: PruningConfig, num_layers: int
                         ) -> tuple[int, ...]:
    """Per-layer important-region budgets as plain ints."""
    floor = max(cfg.v_block_size, 1)
    ratios = cfg.cascade_layer_ratios
    if ratios:
        r = list(ratios) + [ratios[-1]] * max(0, num_layers - len(ratios))
        return tuple(max(floor, int(round(cfg.important_size * r[l])))
                     for l in range(num_layers))
    decay = cfg.cascade_layer_decay
    return tuple(max(floor, int(round(cfg.important_size * decay ** l)))
                 for l in range(num_layers))


def layer_budgets(cfg: PruningConfig, num_layers: int,
                  device: str | torch.device = "cuda") -> torch.Tensor:
    """Per-layer important-region budgets as an int32 tensor [L] on
    ``device`` (default CUDA; the CPU only when asked)."""
    return torch.tensor(layer_budgets_static(cfg, num_layers),
                        dtype=torch.int32, device=resolve_device(device))


def layer_keep_max_static(cfg: PruningConfig, num_layers: int
                          ) -> tuple[int, ...]:
    """Static upper bound on each layer's post-prune live length."""
    return tuple(cfg.start_size + b + cfg.recent_size
                 for b in layer_budgets_static(cfg, num_layers))


def layer_capacities(cfg) -> tuple[int, ...]:
    """Per-layer physical cache-window rungs (static ints): the smallest
    multiple of 2048 above ``keep_max + headroom``, or the capacity itself
    when pruning/rungs are off or the capacity is small (< 4096)."""
    e, p, m = cfg.engine, cfg.pruning, cfg.model
    cap = e.cache_capacity
    flat = (cap,) * m.num_layers
    if not (p.enable_token_pruning and e.layer_cap_rungs):
        return flat
    if cap % 2048 or cap < 4096:
        return flat
    headroom = max(e.layer_cap_headroom, e.prefill_chunk, e.decode_window)
    return tuple(min(cap, -(-(keep_max + headroom) // 2048) * 2048)
                 for keep_max in layer_keep_max_static(p, m.num_layers))


def layer_capacity_groups(cfg) -> tuple[tuple[int, int, int], ...]:
    """Contiguous layer groups of equal capacity rung:
    ((start, end, rung), ...) with end exclusive."""
    groups: list[list[int]] = []
    for l, c in enumerate(layer_capacities(cfg)):
        if groups and groups[-1][2] == c:
            groups[-1][1] = l + 1
        else:
            groups.append([l, l + 1, c])
    return tuple(tuple(g) for g in groups)


def select_keep_indices_budgeted(
    importance: torch.Tensor,       # [L, B, Hkv, C]
    lengths: torch.Tensor,          # [L, B]
    start_size: int,
    important_budget: torch.Tensor,  # int [L], each <= important_size_max
    important_size_max: int,
    recent_size: int,
    num_coming: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-layer budgeted keep selection.

    Returns (keep_idx int32 [L, B, Hkv, keep_max], keep_count int32
    [L, B]) with keep_max = start + important_size_max + (recent -
    num_coming); only the first keep_count[l, b] indices of a row are
    live (the rest are 0, as in the JAX version).
    """
    n_layers, b, hkv, capacity = importance.shape
    dev = importance.device
    recent_keep = recent_size - num_coming
    if recent_keep < 0:
        raise ValueError(
            f"num_coming={num_coming} exceeds recent_size={recent_size}")
    keep_max = start_size + important_size_max + recent_keep
    if keep_max > capacity:
        raise ValueError(f"keep_max {keep_max} exceeds capacity {capacity}")

    pos = torch.arange(capacity, device=dev)
    lengths = lengths.to(torch.int64).reshape(n_layers, b, 1).expand(
        n_layers, b, hkv)
    recent_begin = lengths - recent_keep                       # [L, B, Hkv]
    budget = important_budget.to(torch.int64).reshape(n_layers, 1, 1, 1)

    in_middle = (pos >= start_size) & (pos < recent_begin[..., None])
    masked = torch.where(in_middle, importance.to(torch.float32), _NEG_INF)
    val, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    val, idx = val[..., :important_size_max], idx[..., :important_size_max]
    rank = torch.arange(important_size_max, device=dev)
    valid_imp = (rank < budget) & (val > _NEG_INF)

    imp_key = torch.where(valid_imp, idx, capacity + rank)    # distinct tails
    start_idx = torch.arange(start_size, device=dev).expand(
        n_layers, b, hkv, start_size)
    recent_idx = recent_begin[..., None] + torch.arange(recent_keep,
                                                        device=dev)
    keys = torch.cat([start_idx, imp_key, recent_idx], dim=-1)
    keys = torch.sort(keys, dim=-1).values
    keep_idx = torch.where(keys < capacity, keys, 0).to(torch.int32)

    n_imp = torch.minimum(budget[..., 0],
                          torch.clamp(recent_begin[:, :, :1] - start_size,
                                      min=0))                  # [L, B, 1]
    keep_count = (start_size + n_imp[..., 0] + recent_keep).to(torch.int32)
    return keep_idx, keep_count


def prune_arrays(keep_indices: torch.Tensor, *arrays: torch.Tensor
                 ) -> tuple[torch.Tensor, ...]:
    """Gather the token rows of each array by ``keep_indices`` [...,
    T_keep]: an array [..., C] or [..., C, D] with matching leading dims
    comes back with its token axis compacted to T_keep."""
    idx = keep_indices.to(torch.int64)
    out = []
    for a in arrays:
        if a.ndim == idx.ndim:                     # [..., C]
            out.append(torch.gather(a, -1, idx))
        elif a.ndim == idx.ndim + 1:               # [..., C, D]
            out.append(torch.gather(
                a, -2, idx[..., None].expand(idx.shape + a.shape[-1:])))
        else:
            raise ValueError(f"array rank {a.ndim} incompatible with "
                             f"indices rank {idx.ndim}")
    return tuple(out)
