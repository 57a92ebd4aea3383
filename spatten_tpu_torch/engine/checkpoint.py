"""Checkpoint / resume: parameters and decode-state snapshots (port of
``spatten_tpu/engine/checkpoint.py``).

Both the weights and the live ``DecodeState`` -- the pruned, quantized KV
cache, the importance accumulators, lengths, head masks -- are
snapshotted, so a preempted replica resumes decoding mid-stream without
refetching or re-pruning.  The semantics are the JAX package's; the format
is the port's own (the card's machine has no ``orbax``): a directory
``path`` holding one ``torch.save`` file of CPU tensors, read back with
``weights_only=True`` (no pickled code).  Tensors round-trip byte for
byte, bf16 scales and importance included.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.kv_cache import LayerKVCache
from spatten_tpu_torch.engine.state import DecodeState
from spatten_tpu_torch.ops.quantize import QuantizedKV

PAYLOAD = "checkpoint.pt"


def _tree(x: Any, fn) -> Any:
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, fn) for v in x)
    return fn(x)


def _to_cpu(x: Any) -> Any:
    """A leaf as ``torch.load(weights_only=True)`` reads it back: tensors
    (numpy arrays and numpy scalars become tensors) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu")
    if isinstance(x, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(x))
    return x


def _state_dict(state: DecodeState) -> dict:
    def kv(q: QuantizedKV) -> dict:
        return q._asdict()
    d = state._asdict()
    d["cache"] = {"k": kv(state.cache.k), "v": kv(state.cache.v)}
    return _tree(d, _to_cpu)


def save(path: str, params: Any, state: Optional[DecodeState] = None,
         extra: Any = None) -> None:
    """Write params (and optionally the live decode state, plus any small
    ``extra`` tree -- e.g. a supervisor's loop cursor) to the directory
    ``path``.

    ``params=None`` writes a state-only snapshot (the supervisor rotates
    these every window; rewriting immutable multi-GB weights each time
    would dominate the snapshot cadence).  The file is written beside its
    final name and renamed into place, so a reader never sees half of it."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    payload = {} if params is None else {"params": _tree(params, _to_cpu)}
    if state is not None:
        payload["state"] = _state_dict(state)
    if extra is not None:
        payload["extra"] = _tree(extra, _to_cpu)
    tmp = os.path.join(path, PAYLOAD + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, PAYLOAD))


def _load(path: str) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), PAYLOAD),
                      map_location="cpu", weights_only=True)


def restore_with_extra(path: str, device: str | torch.device = "cuda"
                       ) -> Tuple[Any, Optional[DecodeState], Any]:
    """Read (params, state-or-None, extra-or-None) from ``path`` with a
    single read.  Params and state are placed on ``device`` (default
    CUDA; raises when CUDA is missing); ``extra`` stays on the CPU."""
    dev = resolve_device(device)
    payload = _load(path)
    params, state = _payload_to_state(payload, dev)
    return params, state, payload.get("extra")


def restore(path: str, device: str | torch.device = "cuda"
            ) -> Tuple[Any, Optional[DecodeState]]:
    """Read (params, state-or-None) from ``path``, on ``device``."""
    return restore_with_extra(path, device)[:2]


def _payload_to_state(payload: dict, dev: torch.device
                      ) -> Tuple[Any, Optional[DecodeState]]:
    def on(x):
        return x.to(dev) if isinstance(x, torch.Tensor) else x
    params = payload.get("params")
    if params is not None:
        params = _tree(params, on)
    d = payload.get("state")
    if d is None:
        return params, None

    def kv(t) -> QuantizedKV:
        return QuantizedKV(full=on(t["full"]), msb=on(t.get("msb")),
                           scale=on(t["scale"]), lsb2=on(t.get("lsb2")))
    importance = on(d["importance"])
    lengths = on(d["lengths"])
    num_layers = importance.shape[0]
    layer_lengths = d.get("layer_lengths")
    if layer_lengths is None:           # pre-cascade checkpoints
        layer_lengths = lengths[None].expand(
            (num_layers,) + tuple(lengths.shape)).to(torch.int32).clone()
    quant_bits = d.get("quant_bits")
    if quant_bits is None:              # pre-profile checkpoints: 4-bit
        quant_bits = torch.full((num_layers,), 4, dtype=torch.int32)
    state = DecodeState(
        cache=LayerKVCache(k=kv(d["cache"]["k"]), v=kv(d["cache"]["v"])),
        importance=importance, lengths=lengths,
        layer_lengths=on(layer_lengths), head_mask=on(d["head_mask"]),
        requant_events=on(d["requant_events"]), quant_bits=on(quant_bits))
    return params, state
