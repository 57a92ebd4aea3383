"""Head pruning: remove whole attention heads on the fly (port of
``spatten_tpu/pruning/head_pruning.py``).

A head is pruned by a per-layer boolean mask.  The attention output is
the concat of head outputs followed by a linear o_proj, so zeroing a
pruned head's output removes exactly its contribution; the decode kernel
K1 skips a dead head group's K/V reads and math entirely.  Head
importance is the head's accumulated attention-probability mass.
"""

from __future__ import annotations

from typing import Optional

import torch


def head_importance(token_importance: torch.Tensor,
                    valid_length: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Token importance [..., heads, C] -> [..., heads]; columns at or
    past ``valid_length`` are ignored when it is given."""
    if valid_length is not None:
        cap = token_importance.shape[-1]
        mask = torch.arange(cap, device=token_importance.device) \
            < valid_length
        token_importance = torch.where(mask, token_importance, 0.0)
    return token_importance.sum(dim=-1)


def select_heads(importance: torch.Tensor, keep: int) -> torch.Tensor:
    """Boolean keep-mask of the top-``keep`` heads along the last axis.

    ``jax.lax.top_k`` breaks ties toward the lower index, and with a bf16
    accumulator ties are real, so this selects with a stable descending
    sort (which keeps that order) rather than ``torch.topk``."""
    num_heads = importance.shape[-1]
    if keep <= 0 or keep >= num_heads:
        return torch.ones(importance.shape, dtype=torch.bool,
                          device=importance.device)
    order = torch.sort(importance.to(torch.float32), dim=-1,
                       descending=True, stable=True).indices[..., :keep]
    mask = torch.zeros(importance.shape, dtype=torch.bool,
                       device=importance.device)
    return mask.scatter(-1, order, True)


def apply_head_mask(attn_out: torch.Tensor, head_mask: torch.Tensor
                    ) -> torch.Tensor:
    """Zero pruned heads' outputs.  attn_out [B, H, ...]; head_mask
    [B, H] (trailing axes are added to the mask, as in the JAX function,
    so a 1-D mask would meet the batch axis)."""
    while head_mask.ndim < attn_out.ndim:
        head_mask = head_mask[..., None]
    return torch.where(head_mask, attn_out, 0.0)
