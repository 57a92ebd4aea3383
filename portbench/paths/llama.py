"""The Llama-layout decoder (RMSNorm, RoPE, grouped-query attention,
SwiGLU MLP): the port's ``llama`` model path, the reference in
``reference/spatten_ref.py`` and the counts in ``counts.py``.

The weights are random, made from the run's seed on the device, one call
per stacked tensor.  The tree has the program's layout (``x @ w`` with w
[in, out], layer-stacked leaves [L, ...]): dense weights N(0, 1/fan_in),
norm weights 1."""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from portbench import counts  # noqa: F401  (the path's counts)
from portbench.reference import spatten_ref as reference  # noqa: F401

if TYPE_CHECKING:
    from spatten_tpu_torch.config import SpAttenConfig


def program_config(c: dict) -> SpAttenConfig:
    """The port's configuration for a Llama-layout config file."""
    # imported here: the weights and the reference load nothing of the port
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError(f"hidden_act {c['hidden_act']}: the port's llama "
                         f"path runs SwiGLU")
    for key in ("sliding_window", "rope_scaling"):
        if c.get(key) is not None:
            raise ValueError(f"{key} {c[key]!r}: not on the port's path")
    heads = c["num_attention_heads"]
    s, e = c["spatten"], c["engine"]
    model = ModelConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=heads,
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c.get("head_dim") or c["hidden_size"] // heads,
        intermediate_size=c["intermediate_size"], norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]),
        max_position_embeddings=c["max_position_embeddings"],
        model_type="llama", activation="silu",
        tie_word_embeddings=c["tie_word_embeddings"])
    pruning = PruningConfig(
        start_size=s["start_size"], important_size=s["important_size"],
        recent_size=s["recent_size"], enable_token_pruning=True,
        cascade_layer_ratios=tuple(s["cascade_layer_ratios"]),
        importance_ema=s["importance_ema"],
        enable_v_pruning=s["enable_v_pruning"],
        v_keep_ratio=s["v_keep_ratio"], v_block_size=s["v_block_size"],
        enable_head_pruning=s["enable_head_pruning"],
        head_keep=s["head_keep"],
        head_update_interval=s["head_update_interval"],
        importance_dtype=s["importance_dtype"])
    quant = QuantConfig(
        enabled=s["quant_enabled"], enable_requant=s["enable_requant"],
        requant_threshold=s["requant_threshold"],
        quantize_queries=s["quantize_queries"], pv_int8=s["pv_int8"],
        probs_bf16=s["probs_bf16"], scale_dtype=s["scale_dtype"])
    engine = EngineConfig(
        max_batch_size=e["max_batch_size"],
        cache_capacity=e["cache_capacity"],
        prefill_chunk=e["prefill_chunk"], decode_window=e["decode_window"],
        param_dtype=e["param_dtype"], use_pallas=True,
        rope_mode=e["rope_mode"], layer_cap_rungs=e["layer_cap_rungs"],
        layer_cap_headroom=e["layer_cap_headroom"],
        prefill_fp_score=e["prefill_fp_score"],
        prefill_v_mask=e["prefill_v_mask"])
    return SpAttenConfig(model=model, pruning=pruning, quant=quant,
                         engine=engine).validate()


def make_params(c: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L = c["num_hidden_layers"]
    d = c["hidden_size"]
    hq = c["num_attention_heads"]
    hkv = c["num_key_value_heads"]
    dh = c.get("head_dim") or d // hq
    inter = c["intermediate_size"]
    vocab = c["vocab_size"]

    def dense(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    layers = {
        "attn_norm_w": ones((L, d)),
        "wq": dense((L, d, hq * dh), d),
        "wk": dense((L, d, hkv * dh), d),
        "wv": dense((L, d, hkv * dh), d),
        "wo": dense((L, hq * dh, d), hq * dh),
        "mlp_norm_w": ones((L, d)),
        "w_gate": dense((L, d, inter), d),
        "w_up": dense((L, d, inter), d),
        "w_down": dense((L, inter, d), inter),
    }
    return {"embed": dense((vocab, d), d), "layers": layers,
            "final_norm_w": ones((d,)), "lm_head": dense((d, vocab), d)}
