"""Runtime pruning policy: head masks and quant profiles (port of
``spatten_tpu/engine/policy.py``).

Each head's accumulated probability mass (the sum of its token
importance) ranks it, and the top ``head_keep`` kv-head groups of each
layer stay alive.  Under GQA pruning is decided per kv-head group, since
the group shares its K/V rows; under a latent cache (MLA) every query
head reads the one latent row and keeps its own importance row, so each
query head is ranked on its own (``ModelConfig.importance_heads``).
"""

from __future__ import annotations

import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.engine.state import DecodeState
from spatten_tpu_torch.pruning.head_pruning import select_heads


def head_importance_from_state(state: DecodeState) -> torch.Tensor:
    """Per-(layer, kv head) importance: the accumulated probability mass
    of the valid tokens, summed over the batch.  -> f32 [L, Hkv].

    The columns are masked with ``state.lengths`` (the maximum over
    layers), not with each layer's ``layer_lengths``, exactly as the JAX
    policy does: a deep cascade layer therefore also sums columns that
    are dead under the layer-length contract.  The port keeps this
    behaviour so that both packages derive the same masks; it relies on
    compaction and K1 leaving those dead columns' bytes as JAX does."""
    cap = state.importance.shape[-1]
    valid = (torch.arange(cap, device=state.device)[None, :]
             < state.lengths[:, None])[None, :, None, :]      # [1, B, 1, C]
    imp = torch.where(valid, state.importance.to(torch.float32), 0.0)
    return imp.sum(dim=(1, 3))


def update_head_mask(cfg: SpAttenConfig, state: DecodeState) -> DecodeState:
    """Recompute the per-layer head mask from accumulated importance:
    keep the top ``head_keep`` kv-head groups per layer (0 keeps all) and
    expand each kept group to its query heads."""
    p, m = cfg.pruning, cfg.model
    if not p.enable_head_pruning or p.head_keep <= 0:
        return state
    groups = m.importance_heads
    keep_groups = min(p.head_keep, groups)
    group_mask = select_heads(head_importance_from_state(state), keep_groups)
    q_mask = group_mask.repeat_interleave(m.num_heads // groups, dim=-1)
    return state._replace(head_mask=q_mask)


def quant_profile(cfg: SpAttenConfig) -> dict:
    """The quantization profile as data: per-layer pass-1 plane widths and
    the requant threshold the kernels apply."""
    q = cfg.quant
    if not q.enabled:
        return {"key_bits": -1, "value_bits": -1, "requant": False,
                "threshold": -1.0}
    layer_bits = q.resolved_layer_bits(cfg.model.num_layers)
    return {
        "key_bits": layer_bits[0],
        "key_bits_per_layer": layer_bits,
        "key_bits_requant": 8,
        "value_bits": 8,
        "requant": q.enable_requant,
        "threshold": q.requant_threshold,
    }
