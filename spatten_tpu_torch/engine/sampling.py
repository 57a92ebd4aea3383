"""Token sampling: greedy / temperature / top-k / top-p (port of
``spatten_tpu/engine/sampling.py``).  Randomness comes from an explicit
``torch.Generator``; it draws other numbers than ``jax.random``, so only
greedy decoding reproduces the JAX token stream."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class SamplingParams:
    temperature: float = 0.0      # 0 => greedy
    top_k: int = 0                # 0 => disabled
    top_p: float = 1.0            # 1.0 => disabled

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator],
                 params: SamplingParams) -> torch.Tensor:
    """logits [B, V] -> int32 [B]."""
    if params.greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / params.temperature
    if 0 < params.top_k < logits.shape[-1]:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits, float("-inf"))
    if params.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        cutoff_idx = (cum < params.top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits >= cutoff, logits, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
