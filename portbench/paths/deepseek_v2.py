"""DeepSeek-V2 (multi-head latent attention, routed and shared experts):
the port's ``deepseek_v2`` model path (``config.DeepseekV2Config``), the
reference in ``reference/deepseek_v2_ref.py`` and the counts in
``counts_deepseek_v2.py``.

The weights are random, made from the run's seed on the device, one call
per stacked tensor, in the port's layout (``models/transformer.
_init_deepseek_v2`` describes the tree): dense weights N(0, 1/fan_in),
norm weights 1."""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from portbench import counts_deepseek_v2 as counts  # noqa: F401
from portbench.reference import deepseek_v2_ref as reference  # noqa: F401

if TYPE_CHECKING:
    from spatten_tpu_torch.config import SpAttenConfig

# what the port's path does not run, with the published value it takes
_FIXED = {"q_lora_rank": None, "hidden_act": "silu", "attention_bias": False,
          "topk_method": "greedy", "scoring_func": "softmax",
          "moe_layer_freq": 1, "n_group": 1, "topk_group": 1}


def program_config(c: dict) -> SpAttenConfig:
    """The port's configuration for a DeepSeek-V2 config file."""
    # imported here: the weights and the reference load nothing of the port
    from spatten_tpu_torch.config import (
        DeepseekV2Config, EngineConfig, PruningConfig, QuantConfig,
        SpAttenConfig,
    )
    for key, want in _FIXED.items():
        if c.get(key, want) != want:
            raise ValueError(f"{key} {c[key]!r}: the port's deepseek_v2 path "
                             f"runs {want!r}")
    rs = c.get("rope_scaling") or {}
    if rs and rs.get("type") != "yarn":
        raise ValueError(f"rope_scaling {rs!r}: the path runs YaRN")
    heads = c["num_attention_heads"]
    s, e = c["spatten"], c["engine"]
    model = DeepseekV2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=heads,
        num_kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"] + c["qk_rope_head_dim"],
        intermediate_size=c["intermediate_size"], norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]),
        max_position_embeddings=c["max_position_embeddings"],
        activation="silu", tie_word_embeddings=c["tie_word_embeddings"],
        kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"],
        qk_rope_head_dim=c["qk_rope_head_dim"], v_head_dim=c["v_head_dim"],
        yarn_factor=float(rs.get("factor", 1.0)),
        yarn_original_max_positions=int(
            rs.get("original_max_position_embeddings", 4096)),
        yarn_beta_fast=float(rs.get("beta_fast", 32)),
        yarn_beta_slow=float(rs.get("beta_slow", 1)),
        yarn_mscale=float(rs.get("mscale", 1.0)),
        yarn_mscale_all_dim=float(rs.get("mscale_all_dim", 0.0)),
        n_routed_experts=c["n_routed_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        moe_intermediate_size=c["moe_intermediate_size"],
        n_shared_experts=c["n_shared_experts"],
        first_k_dense_replace=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]),
        norm_topk_prob=bool(c["norm_topk_prob"]))
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
    """The port's DeepSeek-V2 tree from the seed (31.4 GB of bfloat16 at
    DeepSeek-V2-Lite's sizes)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    L, d = c["num_hidden_layers"], c["hidden_size"]
    hq = c["num_attention_heads"]
    rank, nope, rope, vd = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                            c["qk_rope_head_dim"], c["v_head_dim"])
    k = c["first_k_dense_replace"]
    lm, n_exp = L - k, c["n_routed_experts"]
    inter, im = c["intermediate_size"], c["moe_intermediate_size"]
    shared = c["n_shared_experts"] * im
    vocab = c["vocab_size"]

    def dense(shape, fan_in):
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype)
        return t.mul_(1.0 / math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    layers = {
        "attn_norm_w": ones((L, d)),
        "wq": dense((L, d, hq * (nope + rope)), d),
        "wkv_a": dense((L, d, rank + rope), d),
        "kv_a_norm_w": ones((L, rank)),
        "w_uk": dense((L, hq, nope, rank), rank),
        "w_uv": dense((L, hq, rank, vd), rank),
        "wo": dense((L, hq * vd, d), hq * vd),
        "mlp_norm_w": ones((L, d)),
        "dense": {"w_gate": dense((k, d, inter), d),
                  "w_up": dense((k, d, inter), d),
                  "w_down": dense((k, inter, d), inter)},
        "moe": {"router": dense((lm, d, n_exp), d),
                "w_gate_up": dense((lm, n_exp, 2 * im, d), d),
                "w_down": dense((lm, n_exp, d, im), im),
                "shared_gate": dense((lm, d, shared), d),
                "shared_up": dense((lm, d, shared), d),
                "shared_down": dense((lm, shared, d), shared)},
    }
    return {"embed": dense((vocab, d), d), "layers": layers,
            "final_norm_w": ones((d,)), "lm_head": dense((d, vocab), d)}
