"""Prefill (multi-query) attention over the quantized cache.

Port of ``spatten_tpu/ops/prefill_attention.py``.  The JAX version is
plain XLA (no Pallas kernel): a ``lax.scan`` over cache blocks with the
flash recurrence, whose only purpose is to bound XLA's memory at serving
shapes.  Its numerics are defined as equal to
``spatten_attention_reference`` (the JAX tests compare the two directly),
so this port computes the reference's function and returns no
probabilities.  It materializes [B, Hq, S, C] f32 intermediates:
64 MB each at the Llama-2-7B slice (batch 4, chunk 128, capacity 1024).
"""

from __future__ import annotations

from typing import Optional

import torch

from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops.attention_ref import (
    AttentionStats, spatten_attention_reference,
)


def prefill_attention(
    q: torch.Tensor,               # [B, Hq, S, D] (rotated queries)
    k_quant: qz.QuantizedKV,       # planes [B, C(/2), Hkv*D] (token-major)
    v_quant: qz.QuantizedKV,
    cos: Optional[torch.Tensor],   # [C, D]
    sin: Optional[torch.Tensor],
    lengths: torch.Tensor,         # [B] valid tokens incl. queries
    q_positions: torch.Tensor,     # [B, S] cache positions of the queries
    *,
    sm_scale: float,
    requant_threshold: float = 0.0,
    quant_enabled: bool = True,
    v_keep=0,
    v_block_size: int = 16,
    head_mask: Optional[torch.Tensor] = None,
    importance_kind: str = "prob",
    use_rope: bool = True,
    pass1_bits=None,
    per_row_importance: bool = False,
) -> tuple[torch.Tensor, AttentionStats]:
    """Returns (out [B, Hq, S, D] f32, stats without probabilities)."""
    out, stats = spatten_attention_reference(
        q, k_quant, v_quant, cos, sin, lengths, q_positions,
        sm_scale=sm_scale, requant_threshold=requant_threshold,
        quant_enabled=quant_enabled, v_keep=v_keep,
        v_block_size=v_block_size, head_mask=head_mask,
        importance_kind=importance_kind, use_rope=use_rope,
        pass1_bits=pass1_bits, per_row_importance=per_row_importance)
    return out, stats._replace(probs=None)
