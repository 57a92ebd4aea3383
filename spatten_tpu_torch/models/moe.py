"""A routed-expert layer (DeepSeek-V2's MoE): a softmax router in float32,
a greedy top-k, and a dropless dispatch over grouped GEMMs.

``route`` scores every token against every expert in float32 and keeps
its top ``k`` by probability, weighted by those probabilities (optionally
renormalised) times the routed scaling factor.  ``experts`` runs every
picked (token, expert) pair, none dropped and no capacity factor: the
pairs are sorted by expert (a stable sort of the flat expert ids), each
expert's rows are a contiguous run whose end offsets come from a
``searchsorted`` of the sorted ids, and two grouped GEMMs
(``torch._grouped_mm``: gate and up fused, then down) run all experts at
once, an expert that received no token being an empty group.  The rows
go back to their pairs with ``index_copy_`` (each index once, so the
result does not depend on the order of writes) and each token sums its
``k`` rows weighted in float32.  Nothing in the layer reads the device
from the host: the offsets stay on the device, so the layer replays
inside a captured CUDA graph.

Expert weights are stacked [E, out, in] (each expert's matrices as the
published ``nn.Linear`` weights lie); the GEMMs read them transposed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route(h: torch.Tensor, router: torch.Tensor, k: int, *,
          norm_topk: bool = False, scale: float = 1.0
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """h [T, D], router [D, E] -> (weights f32 [T, k], expert ids [T, k]):
    the softmax over every expert in float32, its top ``k`` (greedy)."""
    scores = torch.softmax(h.to(torch.float32) @ router.to(torch.float32),
                           dim=-1)
    weights, idx = torch.topk(scores, k, dim=-1)
    if norm_topk:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    if scale != 1.0:
        weights = weights * scale
    return weights, idx


def experts(h: torch.Tensor, w_gate_up: torch.Tensor, w_down: torch.Tensor,
            weights: torch.Tensor, idx: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The routed experts' output for tokens h [T, D] (h's dtype): each
    token's ``k`` picks ``idx`` [T, k] through SwiGLU experts
    ``w_gate_up`` [E, 2I, D] (gate rows, then up rows) and ``w_down``
    [E, D, I], summed with ``weights`` [T, k] in float32.  Returns (out
    [T, D], the end offsets int32 [E] of each expert's rows)."""
    t, k = idx.shape
    n_exp, two_i, _ = w_gate_up.shape
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    offs = torch.searchsorted(
        flat[order], torch.arange(n_exp, dtype=flat.dtype, device=h.device),
        right=True).to(torch.int32)
    xs = h[order // k]
    gu = torch._grouped_mm(xs, w_gate_up.transpose(-2, -1), offs=offs)
    act = F.silu(gu[:, :two_i // 2]) * gu[:, two_i // 2:]
    ys = torch._grouped_mm(act, w_down.transpose(-2, -1), offs=offs)
    out = torch.empty_like(ys).index_copy_(0, order, ys)
    out = (out.view(t, k, -1).to(torch.float32)
           * weights[..., None]).sum(dim=1)
    return out.to(h.dtype), offs


def counts(offs: torch.Tensor) -> torch.Tensor:
    """Rows each expert received, int32 [E], from the end offsets."""
    return torch.diff(offs, prepend=offs.new_zeros(1))


def experts_loop(h: torch.Tensor, w_gate_up: torch.Tensor,
                 w_down: torch.Tensor, weights: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``experts`` as a plain loop over experts (tests and card checks
    hold the grouped dispatch against it; not a serving path)."""
    t, k = idx.shape
    two_i = w_gate_up.shape[1]
    out = torch.zeros((t, h.shape[1]), dtype=torch.float32, device=h.device)
    for e in range(w_gate_up.shape[0]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = h[tok] @ w_gate_up[e].T
        y = (F.silu(gu[:, :two_i // 2]) * gu[:, two_i // 2:]) @ w_down[e].T
        out.index_add_(0, tok, y.to(torch.float32)
                       * weights[tok, slot][:, None])
    return out.to(h.dtype)
