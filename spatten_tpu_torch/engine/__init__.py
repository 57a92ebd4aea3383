"""Decode engine: quantized pruned KV cache, decode state, sampling and
generation (use ``spatten_tpu_torch.engine.generate.generate``)."""

from spatten_tpu_torch.engine.kv_cache import LayerKVCache, append_tokens
from spatten_tpu_torch.engine.sampling import SamplingParams, sample_token
from spatten_tpu_torch.engine.state import DecodeState, init_state

__all__ = ["LayerKVCache", "append_tokens", "SamplingParams", "sample_token",
           "DecodeState", "init_state"]
