"""Quantized, compacted KV cache (token-major layout).

Port of ``spatten_tpu/engine/kv_cache.py``.  The cache IS the compacted
layout: dense token-major ``[B, capacity, Hkv*D]`` planes where pruning
physically moves survivors to the front, so every attention pass reads a
contiguous prefix ``[0, length)``.

K carries the int8 full plane plus the packed 4-bit msb plane (and the
2-bit lsb2 plane under a 6-bit profile); V carries only the full plane.
In the default "cached" rope mode keys are stored rotated at their slot.

Appends update the planes IN PLACE: the input cache is consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.ops import quantize as qz


class LayerKVCache(NamedTuple):
    """One layer's cache (planes [B, C(/2), Hkv*D]) or the layer-stacked
    cache (leading [L, B])."""

    k: qz.QuantizedKV
    v: qz.QuantizedKV

    @property
    def capacity(self) -> int:
        return self.k.tokens

    def layer(self, l: int) -> "LayerKVCache":
        """Views of layer ``l`` of a stacked cache."""
        return LayerKVCache(k=self.k.layer(l), v=self.v.layer(l))


def init_layer_cache(batch: int, kv_heads: int, capacity: int,
                     head_dim: int, with_msb: bool = True,
                     with_lsb2: bool = False,
                     scale_dtype: torch.dtype = torch.float32,
                     device: str | torch.device = "cuda") -> LayerKVCache:
    """One layer's empty cache (planes [B, C(/2,/4), Hkv*D], scales 1): K
    with the progressive-quantization planes, V with the int8 plane
    alone (P·V reads full precision); on ``device`` (default CUDA; the
    CPU only when asked)."""
    return init_stacked_cache(1, batch, kv_heads, capacity, head_dim,
                              with_msb, with_lsb2, scale_dtype,
                              device).layer(0)


def init_stacked_cache(num_layers: int, batch: int, kv_heads: int,
                       capacity: int, head_dim: int, with_msb: bool = True,
                       with_lsb2: bool = False,
                       scale_dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> LayerKVCache:
    """Layer-stacked cache with leading [L, B]; scales start at 1; on
    ``device`` (default CUDA; the CPU only when asked)."""
    device = resolve_device(device)
    f = kv_heads * head_dim
    lead = (num_layers, batch)

    def planes(msb: bool, lsb2: bool) -> qz.QuantizedKV:
        return qz.QuantizedKV(
            full=torch.zeros(lead + (capacity, f), dtype=torch.int8,
                             device=device),
            msb=torch.zeros(lead + (capacity // 2, f), dtype=torch.uint8,
                            device=device) if msb else None,
            scale=torch.ones(lead + (kv_heads, capacity), dtype=scale_dtype,
                             device=device),
            lsb2=torch.zeros(lead + (capacity // 4, f), dtype=torch.uint8,
                             device=device) if lsb2 else None,
        )

    return LayerKVCache(k=planes(with_msb, with_lsb2), v=planes(False, False))


def _append_rows(q: qz.QuantizedKV, x_new: torch.Tensor, start: torch.Tensor
                 ) -> None:
    """Write S unquantized rows per sequence at slots [start, start+S), in
    place, then re-pack the nibble planes wholesale (a prefill-rate event).

    q planes: [B, C(/2), H*D], scale [B, H, C]; x_new: [B, H, S, D];
    start: [B].
    """
    b, h, s, d = x_new.shape
    q8_new, scale_new = qz.quantize_rows(x_new)           # [B,H,S,D], [B,H,S]
    fused = q8_new.permute(0, 2, 1, 3).reshape(b, s, h * d)
    slots = start.to(torch.int64)[:, None] + torch.arange(
        s, device=x_new.device)[None, :]                  # [B, S]
    bi = torch.arange(b, device=x_new.device)[:, None]
    q.full[bi, slots] = fused
    q.scale[bi[:, :, None], torch.arange(h, device=x_new.device)[None, :, None],
            slots[:, None, :]] = scale_new.to(q.scale.dtype)
    if q.msb is not None:
        q.msb.copy_(qz.pack_msb(q.full))
    if q.lsb2 is not None:
        q.lsb2.copy_(qz.pack_lsb2(q.full))


def append_tokens(cache: LayerKVCache, k_new: torch.Tensor,
                  v_new: torch.Tensor, lengths: torch.Tensor) -> LayerKVCache:
    """Append S new tokens per sequence at its own length offset, IN PLACE
    (the input cache is consumed and returned).

    k_new/v_new: [B, Hkv, S, D] unquantized; lengths: [B] current lengths
    (the new tokens occupy [lengths[b], lengths[b]+S)).
    """
    if k_new.shape[-2] == 1:
        qz.update_token(cache.k, k_new[..., 0, :], lengths)
        qz.update_token(cache.v, v_new[..., 0, :], lengths)
    else:
        _append_rows(cache.k, k_new, lengths)
        _append_rows(cache.v, v_new, lengths)
    return cache


def prune_layer(cache: LayerKVCache, keep_indices: torch.Tensor
                ) -> LayerKVCache:
    """Compact one layer's cache to ``keep_indices`` ([B, Hkv, T_keep],
    sorted): the kept tokens move to the front; the slots past T_keep
    gather slot 0 (stale, masked by the length).  Returns new planes."""
    pad = torch.zeros(keep_indices.shape[:-1]
                      + (cache.capacity - keep_indices.shape[-1],),
                      dtype=keep_indices.dtype, device=keep_indices.device)
    idx = torch.cat([keep_indices, pad], dim=-1)
    return LayerKVCache(k=qz.gather_tokens(cache.k, idx),
                        v=qz.gather_tokens(cache.v, idx))
