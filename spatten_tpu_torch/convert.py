"""Conversion of the JAX package's parameters and decode state, given as
numpy arrays, into the port's tensors -- so that both packages can compute
the same thing on the same inputs (the parity tests).

Nothing here imports JAX: callers pass ``jax.tree.map(np.asarray, tree)``.
The JAX state's NamedTuples are read by field name.  The ``local_``
functions give one rank's part of a global tree on a mesh
(``parallel.mesh.Mesh``: a position will do), cut by the spec trees of
``parallel.sharded`` / ``parallel.pipeline``, as the JAX array's shard at
the same mesh position holds it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.kv_cache import LayerKVCache
from spatten_tpu_torch.engine.state import DecodeState
from spatten_tpu_torch.ops.quantize import QuantizedKV


def tensor_from_numpy(a, device: str | torch.device = "cuda"
                      ) -> torch.Tensor:
    """One numpy array (bfloat16 from ``ml_dtypes`` included) -> tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # copies; keeps 0-d


def params_from_jax(np_tree: Any, device: str | torch.device = "cuda"
                    ) -> Any:
    """Nested dicts of numpy arrays (``init_params`` layout) -> the same
    nesting of tensors on ``device``."""
    dev = resolve_device(device)
    if isinstance(np_tree, dict):
        return {k: params_from_jax(v, dev) for k, v in np_tree.items()}
    return tensor_from_numpy(np_tree, dev)


def _quantized_from_jax(q, dev) -> QuantizedKV:
    def t(x):
        return None if x is None else tensor_from_numpy(x, dev)
    return QuantizedKV(full=t(q.full), msb=t(q.msb), scale=t(q.scale),
                       lsb2=t(q.lsb2))


def state_from_jax(np_state: Any, device: str | torch.device = "cuda"
                   ) -> DecodeState:
    """A JAX ``DecodeState`` whose leaves are numpy arrays -> the port's
    ``DecodeState`` on ``device``."""
    dev = resolve_device(device)
    cache = LayerKVCache(k=_quantized_from_jax(np_state.cache.k, dev),
                         v=_quantized_from_jax(np_state.cache.v, dev))
    return DecodeState(
        cache=cache,
        importance=tensor_from_numpy(np_state.importance, dev),
        lengths=tensor_from_numpy(np_state.lengths, dev),
        layer_lengths=tensor_from_numpy(np_state.layer_lengths, dev),
        head_mask=tensor_from_numpy(np_state.head_mask, dev),
        requant_events=tensor_from_numpy(np_state.requant_events, dev),
        quant_bits=tensor_from_numpy(np_state.quant_bits, dev),
    )


def local_params_from_jax(np_tree: Any, specs: Any, mesh,
                          device: str | torch.device = "cuda") -> Any:
    """One rank's block of a global parameter tree (numpy, ``init_params``
    layout) under ``specs`` (``sharded.param_pspecs`` or
    ``pipeline.pipeline_param_pspecs`` of it) at ``mesh``'s position."""
    from spatten_tpu_torch.parallel.sharded import shard_tree
    dev = resolve_device(device)
    return shard_tree(params_from_jax(np_tree, "cpu"), specs, mesh, dev)


def local_state_from_jax(np_state: Any, specs: Any, mesh,
                         device: str | torch.device = "cuda"
                         ) -> DecodeState:
    """One rank's block of a global JAX ``DecodeState`` (numpy leaves)
    under ``specs`` (``sharded.state_pspecs`` or
    ``pipeline.pipeline_state_pspecs``) at ``mesh``'s position."""
    from spatten_tpu_torch.parallel.sharded import shard_tree
    dev = resolve_device(device)
    return shard_tree(state_from_jax(np_state, "cpu"), specs, mesh, dev)
