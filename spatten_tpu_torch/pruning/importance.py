"""Importance-score accumulation, the signal that drives token, V and head
pruning (port of ``spatten_tpu/pruning/importance.py``).

* "prob": softmax probabilities summed over queries (the HPCA'21 paper).
* "presoftmax": raw scaled QK^T logits summed over queries (parity with
  the reference demo's ``attn_weights`` recording).

Under GQA the cache is shared by a query-head group, so a per-query-head
signal is summed over the group before it can prune shared K/V rows.
"""

from __future__ import annotations

import torch


def importance_from_probs(probs: torch.Tensor) -> torch.Tensor:
    """probs [B, H, q_len, C] -> [B, H, C] (f32 sum over queries)."""
    return probs.to(torch.float32).sum(dim=-2)


def importance_from_scores(scores: torch.Tensor) -> torch.Tensor:
    """Raw scaled logits [B, H, q_len, C] -> [B, H, C]: summed over
    queries only (each sequence prunes on its own)."""
    return scores.to(torch.float32).sum(dim=-2)


def reduce_to_kv_heads(per_q_head: torch.Tensor, num_kv_heads: int
                       ) -> torch.Tensor:
    """Sum a [B, Hq, ...] signal over each GQA group -> [B, Hkv, ...]
    (query heads [g*group, (g+1)*group) share kv head g)."""
    b, h = per_q_head.shape[:2]
    if h % num_kv_heads:
        raise ValueError(f"{h} query heads do not split into "
                         f"{num_kv_heads} kv heads")
    group = h // num_kv_heads
    return per_q_head.reshape((b, num_kv_heads, group)
                              + per_q_head.shape[2:]).sum(dim=2)
