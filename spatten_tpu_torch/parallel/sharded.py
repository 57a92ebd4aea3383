"""Sharded serving: DP (batch) x TP (heads) decode, one process per shard
(port of ``spatten_tpu/parallel/sharded.py``).

The layout is the JAX module's, written as the slices a rank holds
instead of ``PartitionSpec``s over one controller's arrays:

  weights   wq/wk/wv [L, D, H*dh]   -> columns over "model"
            wo       [L, H*dh, D]   -> rows over "model"
            w_gate/up [L, D, I]     -> columns over "model"
            w_down   [L, I, D]      -> rows over "model"
            norms / embed / lm_head / bo / b_down -> replicated
  state     planes [L, B, C, Hkv*D] -> batch over "data", lanes over
            "model"; scales and importance [L, B, Hkv, C] -> batch over
            "data", heads over "model"; lengths by "data", head_mask by
            "model", requant_events replicated
  activ     x [B/dp, S, D] on each rank, replicated over "model"; two
            all-reduces per layer (o_proj, down_proj) over the rank's
            "model" group (``transformer.forward(tp_group=...)``).

A spec is a tuple with one entry per leading dimension, the mesh axis that
dimension is split over or None (``param_pspecs``, ``state_pspecs``), and
``shard_slice`` cuts a rank's part out of a global tensor by it.  As in
the JAX engine, pruning, V pruning and the requant decision are per kv
head, so they run on each rank's own heads with no communication; the
requant count is summed over the whole mesh each step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from spatten_tpu_torch.config import SpAttenConfig
import spatten_tpu_torch.engine.generate as gen
from spatten_tpu_torch.engine.kv_cache import LayerKVCache
from spatten_tpu_torch.engine.state import DecodeState, init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.ops.quantize import QuantizedKV
from spatten_tpu_torch.parallel.mesh import Mesh, all_reduce


def local_config(cfg: SpAttenConfig, mesh: Mesh) -> SpAttenConfig:
    """Config describing one model-shard's slice (local head counts)."""
    tp = mesh.shape["model"]
    m = cfg.model
    if m.num_heads % tp or m.num_kv_heads % tp or m.intermediate_size % tp:
        raise ValueError(
            f"heads {m.num_heads}/{m.num_kv_heads} and intermediate "
            f"{m.intermediate_size} must divide tp={tp}"
        )
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(
            m,
            num_heads=m.num_heads // tp,
            num_kv_heads=m.num_kv_heads // tp,
            intermediate_size=m.intermediate_size // tp,
        ),
    )


_COL3 = (None, None, "model")       # [L, D, out_sharded]
_ROW3 = (None, "model", None)       # [L, in_sharded, D]
_COL2 = (None, "model")             # [L, out_sharded]
LAYER_RULES = {
    "wq": _COL3, "wk": _COL3, "wv": _COL3, "wo": _ROW3,
    "bq": _COL2, "bk": _COL2, "bv": _COL2, "bo": (),
    "w_gate": _COL3, "w_up": _COL3, "w_down": _ROW3,
    "b_up": _COL2, "b_down": (),
    "attn_norm_w": (), "attn_norm_b": (),
    "mlp_norm_w": (), "mlp_norm_b": (),
}


def param_pspecs(params: Any) -> Any:
    """The spec tree of a ``transformer.init_params`` tree (JAX's
    ``param_pspecs``): column-split projections over "model" on their last
    axis, row-split ones on their input axis, the rest replicated."""
    specs = {k: () for k in params if k != "layers"}
    specs["layers"] = {k: LAYER_RULES[k] for k in params["layers"]}
    return specs


def param_keeper(mesh: Mesh, num_layers: int, layer_spec):
    """``keep`` for ``transformer.init_params``: this rank's block of each
    leaf of the whole tree, ``layer_spec(name)`` giving a stacked leaf's
    spec (its first entry the layer axis's) and every other leaf
    replicated.  A rank then draws the whole seeded tree one layer at a
    time and keeps its part, so no rank holds the whole model."""
    def keep(name, layer, t):
        if layer is None:
            return t
        spec = tuple(layer_spec(name))
        axis = spec[0] if spec else None
        if axis is not None:
            per = num_layers // mesh.shape[axis]
            if layer // per != mesh.coords[axis]:
                return None
        return shard_slice(t, spec[1:], mesh)
    return keep


def state_pspecs(state: DecodeState) -> DecodeState:
    """The spec tree of a ``DecodeState`` (JAX's ``state_pspecs``): token-
    major planes [L, B, C, Hkv*D] split on batch over "data" and on the
    fused head-lane axis over "model"; scales and importance [L, B, Hkv,
    C] on batch and heads; the optional nibble planes as the template."""
    plane = (None, "data", None, "model")
    scale = (None, "data", "model", None)

    def kv_spec(t: QuantizedKV) -> QuantizedKV:
        return QuantizedKV(
            full=plane, msb=plane if t.msb is not None else None,
            scale=scale, lsb2=plane if t.lsb2 is not None else None)

    return DecodeState(
        cache=LayerKVCache(k=kv_spec(state.cache.k),
                           v=kv_spec(state.cache.v)),
        importance=(None, "data", "model", None),
        lengths=("data",),
        layer_lengths=(None, "data"),
        head_mask=(None, "model"),
        requant_events=(),
        quant_bits=(),
    )


def shard_slice(t: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a global tensor ``t`` under ``spec``: each
    dimension named by an axis is cut into that axis's size equal parts,
    and the part at the rank's coordinate kept (a view)."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, i = mesh.shape[axis], mesh.coords[axis]
        if t.shape[dim] % n:
            raise ValueError(f"dimension {dim} ({t.shape[dim]}) of a leaf "
                             f"does not split over {axis}={n}")
        size = t.shape[dim] // n
        t = t.narrow(dim, i * size, size)
    return t


def shard_tree(tree: Any, specs: Any, mesh: Mesh,
               device: Optional[torch.device] = None) -> Any:
    """``shard_slice`` over a nested dict / NamedTuple tree of tensors with
    a spec tree of the same structure; each block is copied contiguous to
    ``device`` (default ``mesh.device``).  None leaves stay None."""
    dev = mesh.device if device is None else device
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return shard_slice(tree, specs, mesh).to(dev).contiguous()
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, dev)
                for k, v in tree.items()}
    return type(tree)(*(shard_tree(v, s, mesh, dev)
                        for v, s in zip(tree, specs)))


class ShardedEngine:
    """DP x TP greedy decode on a ("data", "model") mesh of processes: each
    rank runs the step functions on its batch rows and heads."""

    def __init__(self, cfg: SpAttenConfig, mesh: Mesh):
        cfg.validate()
        if tuple(mesh.axis_names) != ("data", "model"):
            raise ValueError("ShardedEngine expects a ('data', 'model') mesh")
        if mesh.coords is None:
            raise ValueError("this rank lies outside the mesh")
        if cfg.engine.max_batch_size % mesh.shape["data"]:
            raise ValueError("batch must divide the data axis")
        self.cfg = cfg
        self.mesh = mesh
        self.lcfg = local_config(cfg, mesh)
        self.device = mesh.device
        self.tp_group = (mesh.group("model") if mesh.shape["model"] > 1
                         else None)

    # -- sharding helpers ---------------------------------------------------

    def rows(self, batch: int) -> slice:
        """This rank's batch rows of a global batch of ``batch``."""
        dp = self.mesh.shape["data"]
        if batch % dp:
            raise ValueError(f"batch {batch} must divide data={dp}")
        n = batch // dp
        i = self.mesh.coords["data"]
        return slice(i * n, (i + 1) * n)

    def shard_params(self, params: Any) -> Any:
        """This rank's slice of a global parameter tree, on its device."""
        return shard_tree(params, param_pspecs(params), self.mesh)

    def init_params(self, generator: torch.Generator | int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> Any:
        """This rank's slice of ``transformer.init_params(cfg.model,
        generator, dtype)``, drawn on its device without the whole tree."""
        return transformer.init_params(
            self.cfg.model, generator, dtype, self.device,
            keep=param_keeper(self.mesh, self.cfg.model.num_layers,
                              LAYER_RULES.__getitem__))

    def init_sharded_state(self, batch: Optional[int] = None) -> DecodeState:
        """This rank's block of an empty global decode state of ``batch``
        sequences: ``init_state`` of the local configuration on the rank's
        rows (the same tensors ``state_pspecs`` cuts from the global
        one)."""
        b = batch if batch is not None else self.cfg.engine.max_batch_size
        n = self.rows(b)
        return init_state(self.lcfg, n.stop - n.start, device=self.device)

    # -- steps --------------------------------------------------------------

    def _global_requants(self, state: DecodeState, aux) -> DecodeState:
        """Fold the requant count of the whole mesh into the replicated
        counter (JAX's psum over ("data", "model"))."""
        total = all_reduce(aux.requant_events.clone(),
                           self.mesh.group("data", "model"))
        prev = state.requant_events - aux.requant_events
        return state._replace(requant_events=prev + total)

    def _step(self, params, state: DecodeState, tokens: torch.Tensor):
        state, _ = gen.maybe_prune(self.lcfg, state, tokens.shape[1])
        logits, state, aux = transformer.forward(
            params, self.lcfg, state, tokens, tp_group=self.tp_group)
        return logits[:, -1], self._global_requants(state, aux)

    def prefill_logits(self, params, state: DecodeState,
                       tokens: torch.Tensor):
        """One prompt chunk [B/dp, S] of this rank's rows: prune first when
        due, then the forward pass.  Consumes ``state``.  Returns (last
        position's logits [B/dp, V], state)."""
        return self._step(params, state, tokens)

    def decode_logits(self, params, state: DecodeState,
                      token: torch.Tensor):
        """One decode step of this rank's rows (token [B/dp]).  Consumes
        ``state``.  Returns (logits [B/dp, V], state)."""
        return self._step(params, state, token[:, None])

    def prefill_step(self):
        """(params, state, tokens [B/dp, S]) -> (logits [B/dp, V], state)."""
        return self.prefill_logits

    def decode_step(self):
        """(params, state, token [B/dp]) -> (greedy next token [B/dp],
        state)."""
        def step(params, state, token):
            logits, state = self.decode_logits(params, state, token)
            return torch.argmax(logits, dim=-1).to(torch.int32), state
        return step

    # -- generation ---------------------------------------------------------

    def generate(self, params, prompt, max_new_tokens: int,
                 eos_token_id: Optional[int] = None) -> torch.Tensor:
        """Greedy generation on the mesh; the global prompt [B, S] (the
        same on every rank) -> the global tokens [B, new] on every rank
        (int32, on the rank's device)."""
        prompt = torch.as_tensor(prompt)
        b, prompt_len = prompt.shape
        rows = self.rows(b)
        state = self.init_sharded_state(b)
        local = prompt[rows].to(self.device, torch.int64)

        prefill, decode = self.prefill_step(), self.decode_step()
        chunk = self.cfg.engine.prefill_chunk
        pos, last_logits = 0, None
        while pos < prompt_len:
            n = min(chunk, prompt_len - pos)
            last_logits, state = prefill(params, state,
                                         local[:, pos:pos + n])
            pos += n

        token = torch.argmax(last_logits, dim=-1).to(torch.int32)
        outs = []
        done = torch.zeros(token.shape, dtype=torch.bool, device=self.device)
        for _ in range(max_new_tokens):
            outs.append(token)
            next_token, state = decode(params, state, token)
            if eos_token_id is not None:
                done = done | (token == eos_token_id)
                next_token = torch.where(done, eos_token_id, next_token)
            token = next_token
        full = torch.zeros((b, max_new_tokens), dtype=torch.int32,
                           device=self.device)
        if outs:
            full[rows] = torch.stack(outs, dim=1)
        # every data shard's rows, on every rank
        return all_reduce(full, self.mesh.group("data"))
