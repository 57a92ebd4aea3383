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
from spatten_tpu_torch.utils.profiling import tracer

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DecodeState(NamedTuple):
    cache: LayerKVCache            # planes stacked [L, B, ...]
    importance: torch.Tensor       # f32 [L, B, Hkv, C] cascade accumulator
                                   # (Hq rows under a latent cache)
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


def write_slot(state: DecodeState, sub: DecodeState, slot: int
               ) -> DecodeState:
    """Scatter a batch-1 sub-state into batch slot ``slot`` of ``state``,
    in place (``state`` is consumed; ``sub`` is read).

    Continuous batching prefills a newly admitted request in its own
    batch-1 state, then writes it into a free slot of the serving arena:
    every cache plane, the importance accumulator and both length
    tensors.  The head mask is global (per layer), not per slot, and is
    left untouched, as in the JAX package."""
    for big, small in zip(state.cache.k + state.cache.v,
                          sub.cache.k + sub.cache.v):
        if big is not None:
            big[:, slot].copy_(small[:, 0])        # leaves are [L, B, ...]
    state.importance[:, slot].copy_(sub.importance[:, 0])
    state.lengths[slot] = sub.lengths[0]
    state.layer_lengths[:, slot].copy_(sub.layer_lengths[:, 0])
    return state


def with_lengths(state: DecodeState, lengths) -> DecodeState:
    """Set nominal lengths and broadcast them to every layer (the uniform
    pre-cascade situation; tests and warm-state builders use this)."""
    lengths = torch.as_tensor(lengths, dtype=torch.int32,
                              device=state.device)
    n_layers = state.layer_lengths.shape[0]
    return state._replace(
        lengths=lengths,
        layer_lengths=lengths[None].expand(
            (n_layers,) + tuple(lengths.shape)).clone())


def init_state(cfg: SpAttenConfig, batch: int | None = None,
               device: str | torch.device = "cuda") -> DecodeState:
    """An empty decode state on ``device`` (raises when ``device`` is CUDA
    and CUDA is unavailable)."""
    dev = resolve_device(device)
    m, e = cfg.model, cfg.engine
    b = batch if batch is not None else e.max_batch_size
    cap = e.cache_capacity
    fields = dict(
        cache=init_stacked_cache(m.num_layers, b, m.cache_heads, cap,
                                 m.cache_dim, with_msb=cfg.quant.enabled,
                                 with_lsb2=cfg.quant.needs_lsb2,
                                 scale_dtype=_DTYPES[cfg.quant.scale_dtype],
                                 device=dev),
        importance=torch.zeros((m.num_layers, b, m.importance_heads, cap),
                               dtype=_DTYPES[cfg.pruning.importance_dtype],
                               device=dev),
        lengths=torch.zeros((b,), dtype=torch.int32, device=dev),
        layer_lengths=torch.zeros((m.num_layers, b), dtype=torch.int32,
                                  device=dev),
        head_mask=torch.ones((m.num_layers, m.num_heads), dtype=torch.bool,
                             device=dev),
        requant_events=torch.zeros((), dtype=torch.int32, device=dev))
    with tracer.sync("state.quant_bits"):
        fields["quant_bits"] = torch.tensor(
            cfg.quant.resolved_layer_bits(m.num_layers), dtype=torch.int32,
            device=dev)
    return DecodeState(**fields)
