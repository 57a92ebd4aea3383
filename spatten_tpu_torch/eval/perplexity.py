"""Teacher-forced perplexity under the SpAtten engine (port of
``spatten_tpu/eval/perplexity.py``).

Streams a token sequence through the engine in chunks of
``prefill_chunk`` (the rolling start/important/recent cache prunes as it
would in serving), accumulating the next-token NLL: the accuracy cost of
cascade token pruning and quantization at the configured ratios."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.device import resolve_device
import spatten_tpu_torch.engine.generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer


@dataclass
class PerplexityResult:
    perplexity: float
    nll: float
    num_tokens: int
    requant_events: int


def _eval_chunk(params, cfg: SpAttenConfig, state, inp, tgt):
    """One teacher-forced chunk: prune if needed, forward, summed NLL.
    Consumes ``state``."""
    state, _ = gen.maybe_prune(cfg, state, inp.shape[1])
    logits, state, _ = transformer.forward(params, cfg, state, inp)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    picked = torch.gather(logp, -1, tgt[..., None])[..., 0]
    return -picked.sum(), state


def evaluate_perplexity(
    params,
    cfg: SpAttenConfig,
    tokens,                       # int [T] or [1, T]
    max_tokens: Optional[int] = None,
    device: str | torch.device = "cuda",
) -> PerplexityResult:
    """NLL of tokens[1:] given the streaming pruned cache, on ``device``
    (default CUDA; ``params`` must live there)."""
    cfg.validate()
    dev = resolve_device(device)
    tokens = np.asarray(tokens).reshape(-1)
    if max_tokens is not None:
        tokens = tokens[: max_tokens + 1]
    t = len(tokens)
    if t < 2:
        raise ValueError("need at least 2 tokens")

    chunk = cfg.engine.prefill_chunk
    state = init_state(cfg, batch=1, device=dev)
    total_nll, total_cnt = 0.0, 0
    seq = torch.as_tensor(tokens, dtype=torch.int64).to(dev)

    pos = 0
    while pos < t - 1:
        n = min(chunk, t - 1 - pos)
        inp = seq[None, pos:pos + n]
        tgt = seq[None, pos + 1:pos + 1 + n]
        nll_chunk, state = _eval_chunk(params, cfg, state, inp, tgt)
        total_nll += float(nll_chunk)
        total_cnt += n
        pos += n

    nll = total_nll / total_cnt
    return PerplexityResult(
        perplexity=float(np.exp(nll)), nll=nll, num_tokens=total_cnt,
        requant_events=int(state.requant_events),
    )
