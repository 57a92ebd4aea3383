"""HuggingFace checkpoint -> the port's parameter tree (port of
``spatten_tpu/models/hf_loader.py``).

Reads a local checkpoint directory tensor by tensor -- safetensors files
or ``pytorch_model*.bin`` files -- transposes each weight into the
layer-stacked layout of ``transformer.init_params``, casts it to the
engine dtype and places it on the device.  It needs neither
``transformers`` nor ``safetensors``: ``read_safetensors`` parses the
format itself (an 8-byte little-endian header length, a JSON header of
name -> dtype, shape and byte offsets, then the raw little-endian
tensors), and ``.bin`` files load with ``torch.load(weights_only=True)``.

Supported families, as in the JAX package: Llama-class
(``LlamaForCausalLM``: llama, vicuna, OpenLLaMA, TinyLlama, ...) and
GPT-2-class (``GPT2LMHeadModel``).
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

import torch

from spatten_tpu_torch.config import ModelConfig
from spatten_tpu_torch.device import resolve_device

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def config_from_hf(hf_cfg: Any) -> ModelConfig:
    """Map a transformers config object (or dict) to ModelConfig, with the
    JAX package's fields and defaults."""
    if not isinstance(hf_cfg, dict):
        hf_cfg = hf_cfg.to_dict()
    mt = hf_cfg.get("model_type", "llama")
    if mt == "llama":
        heads = hf_cfg["num_attention_heads"]
        kv_heads = hf_cfg.get("num_key_value_heads", heads)
        return ModelConfig(
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg["hidden_size"],
            num_layers=hf_cfg["num_hidden_layers"],
            num_heads=heads,
            num_kv_heads=kv_heads,
            head_dim=hf_cfg.get(
                "head_dim", hf_cfg["hidden_size"] // heads),
            intermediate_size=hf_cfg["intermediate_size"],
            norm_eps=hf_cfg.get("rms_norm_eps", 1e-5),
            rope_theta=hf_cfg.get("rope_theta", 10000.0),
            max_position_embeddings=hf_cfg.get("max_position_embeddings",
                                               4096),
            model_type="llama",
            activation="silu",
            tie_word_embeddings=hf_cfg.get("tie_word_embeddings", False),
        )
    if mt == "gpt2":
        heads = hf_cfg["n_head"]
        return ModelConfig(
            vocab_size=hf_cfg["vocab_size"],
            hidden_size=hf_cfg["n_embd"],
            num_layers=hf_cfg["n_layer"],
            num_heads=heads,
            num_kv_heads=heads,
            head_dim=hf_cfg["n_embd"] // heads,
            intermediate_size=hf_cfg.get("n_inner") or 4 * hf_cfg["n_embd"],
            norm_eps=hf_cfg.get("layer_norm_epsilon", 1e-5),
            max_position_embeddings=hf_cfg.get("n_positions", 1024),
            model_type="gpt2",
            activation="gelu",
            use_qkv_bias=True,
            use_mlp_bias=True,
            layernorm_kind="layernorm",
            use_abs_pos_emb=True,
            tie_word_embeddings=True,
        )
    raise ValueError(f"unsupported model_type {mt!r} (llama and gpt2 are "
                     "supported)")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, on the CPU, in its
    stored dtype (the header's ``__metadata__`` entry is skipped)."""
    with open(path, "rb") as fh:
        data = fh.read()
    n = int.from_bytes(data[:8], "little")
    header = json.loads(data[8:8 + n])
    buf = bytearray(data[8 + n:])
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        dtype = _ST_DTYPES[info["dtype"]]
        t = torch.frombuffer(buf, dtype=torch.uint8, count=end - start,
                             offset=start) if end > start else \
            torch.empty(0, dtype=torch.uint8)
        out[name] = t.view(dtype).reshape(info["shape"])
    return out


def read_checkpoint_tensors(path: str) -> Dict[str, torch.Tensor]:
    """All tensors of a local HF checkpoint directory (safetensors files
    when there are any, else ``pytorch_model*.bin``), on the CPU."""
    tensors: Dict[str, torch.Tensor] = {}
    st_files = sorted(f for f in os.listdir(path)
                      if f.endswith(".safetensors"))
    if st_files:
        for f in st_files:
            tensors.update(read_safetensors(os.path.join(path, f)))
        return tensors
    bin_files = sorted(f for f in os.listdir(path)
                       if f.startswith("pytorch_model") and f.endswith(".bin"))
    if bin_files:
        for f in bin_files:
            tensors.update(torch.load(os.path.join(path, f),
                                      map_location="cpu", weights_only=True))
        return tensors
    raise FileNotFoundError(f"no safetensors/bin weights under {path}")


def load_model_config(path: str) -> ModelConfig:
    with open(os.path.join(path, "config.json")) as fh:
        return config_from_hf(json.load(fh))


def params_from_hf_state_dict(
    tensors: Dict[str, torch.Tensor], cfg: ModelConfig,
    dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda",
) -> Dict[str, Any]:
    """Assemble the layer-stacked parameter tree from HF tensor names:
    each tensor is read as f32, transposed or split as the JAX loader
    does, then cast to ``dtype`` on ``device``."""
    dev = resolve_device(device)
    if cfg.model_type == "llama":
        return _llama_params(tensors, cfg, dtype, dev)
    if cfg.model_type == "gpt2":
        return _gpt2_params(tensors, cfg, dtype, dev)
    raise ValueError(cfg.model_type)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _stack(get: Callable[[int], torch.Tensor], n: int, dtype, dev
           ) -> torch.Tensor:
    return torch.stack([_f32(get(i)) for i in range(n)]).to(dev, dtype)


def _llama_params(t, cfg: ModelConfig, dtype, dev):
    L = cfg.num_layers
    pre = "model." if "model.embed_tokens.weight" in t else ""

    def w(name):
        return t[f"{pre}{name}"]

    def lw(i, name):     # HF Linear stores [out, in]; ours is [in, out]
        return _f32(t[f"{pre}layers.{i}.{name}.weight"]).T

    def stack(fn):
        return _stack(fn, L, dtype, dev)

    layers = {
        "attn_norm_w": stack(lambda i: w(f"layers.{i}.input_layernorm.weight")),
        "wq": stack(lambda i: lw(i, "self_attn.q_proj")),
        "wk": stack(lambda i: lw(i, "self_attn.k_proj")),
        "wv": stack(lambda i: lw(i, "self_attn.v_proj")),
        "wo": stack(lambda i: lw(i, "self_attn.o_proj")),
        "mlp_norm_w": stack(
            lambda i: w(f"layers.{i}.post_attention_layernorm.weight")),
        "w_gate": stack(lambda i: lw(i, "mlp.gate_proj")),
        "w_up": stack(lambda i: lw(i, "mlp.up_proj")),
        "w_down": stack(lambda i: lw(i, "mlp.down_proj")),
    }
    params = {
        "embed": _f32(w("embed_tokens.weight")).to(dev, dtype),
        "layers": layers,
        "final_norm_w": _f32(w("norm.weight")).to(dev, dtype),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = _f32(t["lm_head.weight"]).T.to(dev, dtype)
    return params


def _gpt2_params(t, cfg: ModelConfig, dtype, dev):
    L = cfg.num_layers
    pre = "transformer." if "transformer.wte.weight" in t else ""

    def w(name):
        return _f32(t[f"{pre}{name}"])

    # GPT-2 Conv1D stores [in, out] already; c_attn packs qkv on the last
    # axis
    def split_qkv(i, part, bias=False):
        kind = "bias" if bias else "weight"
        return torch.chunk(w(f"h.{i}.attn.c_attn.{kind}"), 3, dim=-1)[part]

    def stack(fn):
        return _stack(fn, L, dtype, dev)

    layers = {
        "attn_norm_w": stack(lambda i: w(f"h.{i}.ln_1.weight")),
        "attn_norm_b": stack(lambda i: w(f"h.{i}.ln_1.bias")),
        "wq": stack(lambda i: split_qkv(i, 0)),
        "wk": stack(lambda i: split_qkv(i, 1)),
        "wv": stack(lambda i: split_qkv(i, 2)),
        "bq": stack(lambda i: split_qkv(i, 0, True)),
        "bk": stack(lambda i: split_qkv(i, 1, True)),
        "bv": stack(lambda i: split_qkv(i, 2, True)),
        "wo": stack(lambda i: w(f"h.{i}.attn.c_proj.weight")),
        "bo": stack(lambda i: w(f"h.{i}.attn.c_proj.bias")),
        "mlp_norm_w": stack(lambda i: w(f"h.{i}.ln_2.weight")),
        "mlp_norm_b": stack(lambda i: w(f"h.{i}.ln_2.bias")),
        "w_up": stack(lambda i: w(f"h.{i}.mlp.c_fc.weight")),
        "b_up": stack(lambda i: w(f"h.{i}.mlp.c_fc.bias")),
        "w_down": stack(lambda i: w(f"h.{i}.mlp.c_proj.weight")),
        "b_down": stack(lambda i: w(f"h.{i}.mlp.c_proj.bias")),
    }
    return {
        "embed": w("wte.weight").to(dev, dtype),
        "wpe": w("wpe.weight").to(dev, dtype),
        "layers": layers,
        "final_norm_w": w("ln_f.weight").to(dev, dtype),
        "final_norm_b": w("ln_f.bias").to(dev, dtype),
    }


def load_pretrained(path: str, dtype: torch.dtype = torch.bfloat16,
                    device: str | torch.device = "cuda"):
    """Load (cfg, params) from a local HF checkpoint directory onto
    ``device`` (default CUDA; raises when CUDA is missing)."""
    cfg = load_model_config(path)
    tensors = read_checkpoint_tensors(path)
    return cfg, params_from_hf_state_dict(tensors, cfg, dtype, device)
