"""Decode engine: quantized pruned KV cache, decode state, generation,
continuous-batching server and sampling (use
``spatten_tpu_torch.engine.generate.generate``: the function is not
re-exported, so that the name stays the submodule's)."""

from spatten_tpu_torch.engine.kv_cache import (
    LayerKVCache, append_tokens, init_layer_cache,
)
from spatten_tpu_torch.engine.sampling import SamplingParams, sample_token
from spatten_tpu_torch.engine.state import DecodeState, init_state, write_slot
from spatten_tpu_torch.engine.generate import (
    GenerateResult, decode_step, maybe_prune, prefill_chunk,
)
from spatten_tpu_torch.engine.server import Request, SpAttenServer

__all__ = ["LayerKVCache", "append_tokens", "init_layer_cache",
           "SamplingParams", "sample_token", "DecodeState", "init_state",
           "write_slot", "GenerateResult", "decode_step", "maybe_prune",
           "prefill_chunk", "Request", "SpAttenServer"]
