"""Pos-shift rotary embeddings (port of ``spatten_tpu/ops/rope.py``).

Queries are rotated at their cache position and keys at their cache slot
(``arange(kv_len)``), so evicting tokens never leaves positional holes.
HF "rotate_half" convention: the head dim splits into halves [x1, x2],
rotated as (x1*cos - x2*sin, x2*cos + x1*sin).
"""

from __future__ import annotations

import torch


def rope_table(max_positions: int, head_dim: int, theta: float = 10000.0,
               device: str | torch.device = "cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_positions, head_dim], f32."""
    inv_freq = 1.0 / (theta ** (
        torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
        / head_dim))
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` [..., seq, head_dim] at ``positions`` [seq]."""
    c = cos[positions].to(x.dtype)
    s = sin[positions].to(x.dtype)
    return x * c + rotate_half(x) * s


def apply_rope_at_cache_positions(k: torch.Tensor, cos: torch.Tensor,
                                  sin: torch.Tensor) -> torch.Tensor:
    """Rotate cached keys [..., cache_len, head_dim] at their slots."""
    positions = torch.arange(k.shape[-2], device=k.device)
    return apply_rope(k, cos, sin, positions)
