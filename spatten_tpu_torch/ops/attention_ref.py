"""Reference SpAtten attention over a quantized, pruned KV cache.

Port of ``spatten_tpu/ops/attention_ref.py``, the numerics anchor: a
dense-shaped, masked implementation of the whole pipeline

    MSB-plane QK^T -> softmax -> requant decision -> (full-plane recompute
    for low-confidence heads) -> local-V top-k -> P·V

plus the importance epilogue that drives cascade token pruning.  The
plain version of the decode kernel (``ops/fused_decode.py``) is this
function over the post-append cache.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops import rope as rope_ops

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


class AttentionStats(NamedTuple):
    """Pruning/quantization signals emitted by the attention epilogue."""

    max_prob: torch.Tensor           # [B, Hkv] max softmax prob (pass 1)
    need_requant: torch.Tensor       # [B, Hkv] bool
    importance_delta: torch.Tensor   # [B, Hkv, C] (or the accumulator)
    probs: Optional[torch.Tensor]    # [B, Hq, q_len, C] post plane-select


def repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """[B, Hkv, ...] -> [B, Hkv*group, ...] (HF repeat_kv ordering)."""
    b, hkv = x.shape[:2]
    x = x[:, :, None].expand((b, hkv, group) + x.shape[2:])
    return x.reshape((b, hkv * group) + x.shape[3:])


def group_reduce(x: torch.Tensor, num_kv_heads: int, op) -> torch.Tensor:
    """[B, Hq, ...] -> [B, Hkv, ...] reducing over each GQA group with
    ``op(tensor, dim)``."""
    b, hq = x.shape[:2]
    return op(x.reshape((b, num_kv_heads, hq // num_kv_heads)
                        + x.shape[2:]), 2)


def kth_block_mass(block_mass: torch.Tensor, v_keep, block_size: int
                   ) -> torch.Tensor:
    """The keep threshold (k-th largest block mass) per row, [..., 1].

    ``v_keep`` is a python int or an int tensor scalar (a per-layer value
    budget).  Compare ``block_mass >= kth`` to keep (ties are kept)."""
    num_blocks = block_mass.shape[-1]
    if isinstance(v_keep, int):
        keep_blocks = max(1, -(-v_keep // block_size))
        if keep_blocks >= num_blocks:
            return torch.full(block_mass.shape[:-1] + (1,), float("-inf"),
                              device=block_mass.device)
        return torch.topk(block_mass, keep_blocks, dim=-1).values[..., -1:]
    kb = max(1, -(-int(v_keep) // block_size))
    srt = torch.sort(block_mass, dim=-1, descending=True).values
    ki = min(max(kb - 1, 0), num_blocks - 1)
    return srt[..., ki:ki + 1]


def v_block_keep_mask(probs: torch.Tensor, v_keep, block_size: int
                      ) -> torch.Tensor:
    """Local V pruning mask at block granularity, bool [..., C]: blocks of
    ``block_size`` tokens score by summed probability mass and the top
    ceil(v_keep/block_size) blocks are kept."""
    cap = probs.shape[-1]
    if cap % block_size:
        raise ValueError("capacity must be a multiple of the V block size")
    blocked = probs.reshape(probs.shape[:-1] + (cap // block_size,
                                                block_size))
    block_mass = blocked.sum(dim=-1)
    kth = kth_block_mass(block_mass, v_keep, block_size)
    keep = block_mass >= kth
    return keep.repeat_interleave(block_size, dim=-1)


def spatten_attention_reference(
    q: torch.Tensor,               # [B, Hq, q_len, D] (already rotated)
    k_quant: qz.QuantizedKV,       # planes [B, C(/2), Hkv*D], scale [B,Hkv,C]
    v_quant: qz.QuantizedKV,
    cos: Optional[torch.Tensor],   # rope tables [P, D] (use_rope only)
    sin: Optional[torch.Tensor],
    length: torch.Tensor,          # [B] valid tokens incl. queries
    q_positions: torch.Tensor,     # [q_len] or [B, q_len] cache positions
    *,
    sm_scale: float,
    requant_threshold: float = 0.0,
    quant_enabled: bool = True,
    v_keep=0,                      # 0 disables local V pruning
    v_block_size: int = 16,
    head_mask: Optional[torch.Tensor] = None,   # [Hq] or [B, Hq] bool
    importance_kind: str = "prob",
    use_rope: bool = True,
    pass1_bits=None,               # int 4/6/8: this layer's profile
    per_row_importance: bool = False,
) -> tuple[torch.Tensor, AttentionStats]:
    """Returns (output [B, Hq, q_len, D] f32, stats).
    ``per_row_importance``: the importance delta per query head [B, Hq,
    C] (a latent cache's rows), not summed over each GQA group."""
    b, hq, q_len, d = q.shape
    hkv = k_quant.heads
    cap = k_quant.tokens
    group = hq // hkv
    dev = q.device
    if length.ndim == 0:
        length = length.expand(b)

    def rotated_keys(deq_fn):
        k = deq_fn(k_quant, torch.float32)               # [B, Hkv, C, D]
        if not use_rope:
            return k
        return rope_ops.apply_rope_at_cache_positions(k, cos, sin)

    pos_k = torch.arange(cap, device=dev)
    valid = pos_k[None, :] < length[:, None]                      # [B, C]
    if q_positions.ndim == 1:
        q_positions = q_positions[None].expand(b, q_len)
    causal = pos_k[None, None, :] <= q_positions[:, :, None]      # [B,q,C]
    mask = valid[:, None, None, :] & causal[:, None, :, :]        # [B,1,q,C]
    qf = q.to(torch.float32)

    def scores_for(k_rot):
        k_rep = repeat_kv(k_rot, group)                           # [B,Hq,C,D]
        return torch.einsum("bhqd,bhcd->bhqc", qf, k_rep) * sm_scale

    def softmax_masked(s):
        s = torch.where(mask, s, MASK_VALUE)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        e = torch.where(mask, e, 0.0)
        denom = e.sum(dim=-1, keepdim=True)
        return e / torch.clamp(denom, min=1e-30)

    if quant_enabled and pass1_bits is not None:
        bits = int(pass1_bits)
        if bits >= 8:
            deq = qz.dequantize_full
        elif bits == 6 and k_quant.lsb2 is not None:
            deq = qz.dequantize_6bit
        else:                           # no lsb2 plane: 6 degrades to 4
            deq = qz.dequantize_msb
        scores_msb = scores_for(rotated_keys(deq))
    elif quant_enabled:
        scores_msb = scores_for(rotated_keys(qz.dequantize_msb))
    else:
        scores_msb = scores_for(rotated_keys(qz.dequantize_full))
    probs_msb = softmax_masked(scores_msb)

    # requant decision: per (B, Hkv) max prob over its group and queries
    max_prob = group_reduce(probs_msb.amax(dim=(-1, -2)), hkv,
                            lambda x, a: x.amax(dim=a))           # [B, Hkv]
    do_requant = quant_enabled and requant_threshold > 0.0
    if do_requant:
        need_requant = max_prob < requant_threshold
        if pass1_bits is not None and int(pass1_bits) >= 8:
            # an 8-bit pass-1 already read the full plane
            need_requant = torch.zeros_like(need_requant)
        scores_full = scores_for(rotated_keys(qz.dequantize_full))
        probs_full = softmax_masked(scores_full)
        sel = repeat_kv(need_requant[..., None, None], group)     # [B,Hq,1,1]
        probs = torch.where(sel, probs_full, probs_msb)
        scores = torch.where(sel, scores_full, scores_msb)
    else:
        need_requant = torch.zeros((b, hkv), dtype=torch.bool, device=dev)
        probs, scores = probs_msb, scores_msb

    # head pruning: a masked head computes nothing; a fully masked group
    # reports zero stats
    if head_mask is not None:
        hm = head_mask if head_mask.ndim == 2 else head_mask[None, :]
        hm = hm.expand(b, hq)
        probs = torch.where(hm[:, :, None, None], probs, 0.0)
        scores = torch.where(hm[:, :, None, None], scores, 0.0)
        group_alive = group_reduce(hm, hkv, lambda x, a: x.any(dim=a))
        max_prob = torch.where(group_alive, max_prob, 0.0)
        need_requant = need_requant & group_alive

    # importance epilogue (pre V-pruning, pre renormalisation)
    if importance_kind == "prob":
        imp = probs
    elif importance_kind == "presoftmax":
        imp = torch.where(mask, scores, 0.0)
    else:
        raise ValueError(importance_kind)
    if per_row_importance:
        importance_delta = imp.sum(dim=-2)                         # [B,Hq,C]
    else:
        importance_delta = group_reduce(imp.sum(dim=-2), hkv,
                                        lambda x, a: x.sum(dim=a))  # [B,Hkv,C]

    # local V pruning: keep the top-v_keep tokens' probability mass
    if not isinstance(v_keep, int) or v_keep > 0:
        vmask = v_block_keep_mask(probs, v_keep, v_block_size)
        probs_pv = torch.where(vmask, probs, 0.0)
    else:
        probs_pv = probs

    v = qz.dequantize_full(v_quant, torch.float32)               # [B,Hkv,C,D]
    out = torch.einsum("bhqc,bhcd->bhqd", probs_pv, repeat_kv(v, group))
    return out, AttentionStats(max_prob=max_prob, need_requant=need_requant,
                               importance_delta=importance_delta,
                               probs=probs)
