"""Decode state threaded through the engine (port of
``spatten_tpu/engine/state.py``).

The JAX state is an immutable pytree; here the tensors are updated in
place where the JAX functions return updated copies, and functions that
do so say that their input state is consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.kv_cache import LayerKVCache, init_stacked_cache

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DecodeState(NamedTuple):
    cache: LayerKVCache            # planes stacked [L, B, ...]
    importance: torch.Tensor       # f32 [L, B, Hkv, C] cascade accumulator
    lengths: torch.Tensor          # int32 [B] nominal tokens per sequence
    layer_lengths: torch.Tensor    # int32 [L, B] live tokens per layer
    head_mask: torch.Tensor        # bool [L, Hq] (False = pruned head)
    requant_events: torch.Tensor   # int32 [] cumulative requant recomputes
    quant_bits: torch.Tensor       # int32 [L] pass-1 bits per layer

    @property
    def capacity(self) -> int:
        return self.importance.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.importance.device

    def clone(self, device: torch.device | None = None) -> "DecodeState":
        """A deep copy (every tensor cloned), on ``device`` when given."""
        def c(x):
            if x is None:
                return None
            return x.clone() if device is None else x.to(device, copy=True)
        cache = LayerKVCache(
            k=type(self.cache.k)(*(c(x) for x in self.cache.k)),
            v=type(self.cache.v)(*(c(x) for x in self.cache.v)))
        return DecodeState(cache, *(c(x) for x in self[1:]))


def init_state(cfg: SpAttenConfig, batch: int | None = None,
               device: str | torch.device = "cuda") -> DecodeState:
    """An empty decode state on ``device`` (raises when ``device`` is CUDA
    and CUDA is unavailable)."""
    dev = resolve_device(device)
    m, e = cfg.model, cfg.engine
    b = batch if batch is not None else e.max_batch_size
    cap = e.cache_capacity
    return DecodeState(
        cache=init_stacked_cache(m.num_layers, b, m.num_kv_heads, cap,
                                 m.head_dim, with_msb=cfg.quant.enabled,
                                 with_lsb2=cfg.quant.needs_lsb2,
                                 scale_dtype=_DTYPES[cfg.quant.scale_dtype],
                                 device=dev),
        importance=torch.zeros((m.num_layers, b, m.num_kv_heads, cap),
                               dtype=_DTYPES[cfg.pruning.importance_dtype],
                               device=dev),
        lengths=torch.zeros((b,), dtype=torch.int32, device=dev),
        layer_lengths=torch.zeros((m.num_layers, b), dtype=torch.int32,
                                  device=dev),
        head_mask=torch.ones((m.num_layers, m.num_heads), dtype=torch.bool,
                             device=dev),
        requant_events=torch.zeros((), dtype=torch.int32, device=dev),
        quant_bits=torch.tensor(cfg.quant.resolved_layer_bits(m.num_layers),
                                dtype=torch.int32, device=dev),
    )
