"""Random weights of a Llama-layout decoder, made from the run's seed on
the device, in bfloat16, one call per stacked tensor.

The benchmark makes them and hands the same tensors to the program and
to the reference.  The tree has the program's layout (``x @ w`` with w
[in, out], layer-stacked leaves [L, ...]): dense weights N(0, 1/fan_in),
norm weights 1."""

from __future__ import annotations

import math

import torch


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
