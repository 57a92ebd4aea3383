"""Pos-shift rotary embeddings (port of ``spatten_tpu/ops/rope.py``).

Queries are rotated at their cache position and keys at their cache slot
(``arange(kv_len)``), so evicting tokens never leaves positional holes.
HF "rotate_half" convention: the head dim splits into halves [x1, x2],
rotated as (x1*cos - x2*sin, x2*cos + x1*sin).

``model_rope_table`` and ``rope_lanes`` are the one place a model's
configuration turns into rotation angles: the tables every forward
reads, and the lanes and frequencies a prune's re-rotation
(``pruning/compact.rotate_moved_rows``) turns a moved cached row by.  A
Llama-layout model rotates every lane of a head at ``rope_theta``; a
DeepSeek-V2 model (``config.DeepseekV2Config``) rotates the last
``qk_rope_head_dim`` lanes at YaRN's frequencies.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from spatten_tpu_torch.device import resolve_device


def inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    """RoPE's inverse frequencies ``theta ** -(2i / dim)``, f32 [dim/2]."""
    return 1.0 / (theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))


def rope_table(max_positions: int, head_dim: int, theta: float = 10000.0,
               device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) tables of shape [max_positions, head_dim], f32, on
    ``device`` (default CUDA; the CPU only when asked)."""
    device = resolve_device(device)
    return _table(max_positions, inv_freq(head_dim, theta, device), device)


def _table(max_positions: int, freq: torch.Tensor, device,
           mscale: float = 1.0) -> tuple[torch.Tensor, torch.Tensor]:
    t = torch.arange(max_positions, dtype=torch.float32, device=device)
    freqs = torch.outer(t, freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    if mscale != 1.0:
        return torch.cos(emb) * mscale, torch.sin(emb) * mscale
    return torch.cos(emb), torch.sin(emb)


def yarn_inv_freq(dim: int, theta: float, factor: float,
                  original_max_positions: int, beta_fast: float,
                  beta_slow: float, device) -> torch.Tensor:
    """YaRN's inverse frequencies, f32 [dim/2] (the published
    ``DeepseekV2YarnRotaryEmbedding``): the plain frequencies below the
    correction range's low end, those divided by ``factor`` above its high
    end, a linear ramp between.  The range holds the lanes that turn
    ``beta_fast`` to ``beta_slow`` times over ``original_max_positions``."""
    def correction_dim(rotations: float) -> float:
        return (dim * math.log(original_max_positions
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = max(math.floor(correction_dim(beta_fast)), 0)
    high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp(
        (torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
        / (high - low), 0, 1)
    extra = inv_freq(dim, theta, device)
    inter = 1.0 / (factor * theta ** (
        torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def model_inv_freq(model, device) -> torch.Tensor:
    """The inverse frequencies of ``model``'s rotated lanes."""
    dim = model.rope_dim
    if model.latent and model.yarn_factor > 1.0:
        return yarn_inv_freq(dim, model.rope_theta, model.yarn_factor,
                             model.yarn_original_max_positions,
                             model.yarn_beta_fast, model.yarn_beta_slow,
                             device)
    return inv_freq(dim, model.rope_theta, device)


def model_rope_table(model, max_positions: int,
                     device: str | torch.device = "cuda"
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [max_positions, model.rope_dim] for ``model`` (a
    ``config.ModelConfig``): ``rope_table`` at ``rope_theta`` over the head
    for a Llama-layout model; YaRN's frequencies over the rope lanes,
    scaled by ``mscale(factor, mscale) / mscale(factor, mscale_all_dim)``,
    for DeepSeek-V2."""
    if not model.latent:
        return rope_table(max_positions, model.head_dim, model.rope_theta,
                          device)
    from spatten_tpu_torch.config import yarn_mscale
    device = resolve_device(device)
    mscale = 1.0
    if model.yarn_factor > 1.0:
        mscale = (yarn_mscale(model.yarn_factor, model.yarn_mscale)
                  / yarn_mscale(model.yarn_factor, model.yarn_mscale_all_dim))
    return _table(max_positions, model_inv_freq(model, device), device,
                  mscale)


class RopeLanes(NamedTuple):
    """The rotated lanes of a cached row: lanes ``first`` onward, turned
    in the rotate-half convention at ``inv_freq`` [lanes / 2]."""

    first: int
    inv_freq: torch.Tensor


def rope_lanes(model, device) -> RopeLanes:
    """The lanes of ``model``'s cached row that carry a rotation and
    their frequencies: the whole head for a Llama-layout model; the last
    ``qk_rope_head_dim`` lanes of the latent row for DeepSeek-V2."""
    return RopeLanes(model.cache_dim - model.rope_dim,
                     model_inv_freq(model, device))


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """Lanes [x0, x1, x2, x3, ...] -> [x0, x2, ..., x1, x3, ...]: the
    order DeepSeek-V2 puts its rope lanes in before ``rotate_half``."""
    return x.unflatten(-1, (x.shape[-1] // 2, 2)).transpose(-1, -2).flatten(
        -2)


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
