"""Pipeline parallelism: layer stages over the "pipe" axis of a mesh of
processes (port of ``spatten_tpu/parallel/pipeline.py``).

* Parameters and decode state are layer-stacked ``[L, ...]``; a stage
  holds ``L/P`` contiguous layers of both (``pipeline_param_pspecs``,
  ``pipeline_state_pspecs``), so pruning state stays stage-local; with a
  "model" axis of more than one rank each stage's weights and heads split
  over it too (the composed PP x TP layout of ``sharded.py``).
* Embedding and lm_head weights are replicated; stage ``s`` runs its
  layers with ``layer_offset = s * L/P`` and hands the activations to
  stage ``s+1`` (``mesh.send`` / ``mesh.recv``, JAX's ``ppermute``); the
  last stage's logits reach every rank through a masked all-reduce over
  "pipe", as JAX's masked psum.
* ``microbatches`` M > 1 runs the GPipe schedule of JAX's
  ``_local_step_micro``: over M + P - 1 ticks, stage ``s`` runs
  microbatch ``t - s`` on its batch rows at tick ``t``.  Stage-local
  updates of a microbatch's rows go to views of the stage's state, in
  place.

Every stage reads its local configuration (``pipeline_local_config``:
``L/P`` layers) wherever the JAX stage does: the cascade budgets, the V
budgets, the capacity rungs and the prune triggers are those of an
``L/P``-layer model (ROADMAP lists this reference quirk), while the layer
bits are the global model's, cut by stage.  Each stage's ``lengths``
follow its own layers after a prune, as each JAX device's copy of the
"replicated" lengths does.
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
from spatten_tpu_torch.parallel.mesh import Mesh, all_reduce, recv, send
from spatten_tpu_torch.parallel.sharded import (
    LAYER_RULES, local_config, param_keeper, param_pspecs, shard_tree,
)


def pipeline_local_config(cfg: SpAttenConfig, stages: int) -> SpAttenConfig:
    m = cfg.model
    if m.num_layers % stages:
        raise ValueError(
            f"num_layers {m.num_layers} must divide stages {stages}")
    return dataclasses.replace(
        cfg, model=dataclasses.replace(
            m, num_layers=m.num_layers // stages))


def pipeline_param_pspecs(params: Any, tp: bool = False) -> Any:
    """Layer stacks split over "pipe" on their layer axis; with ``tp``,
    each layer's weights also over "model" as ``param_pspecs`` places
    them; everything else replicated."""
    specs = {k: () for k in params if k != "layers"}
    if tp:
        base = param_pspecs(params)["layers"]
        specs["layers"] = {k: ("pipe",) + tuple(v)[1:]
                           for k, v in base.items()}
    else:
        specs["layers"] = {k: ("pipe",) for k in params["layers"]}
    return specs


def pipeline_state_pspecs(state: DecodeState, tp: bool = False
                          ) -> DecodeState:
    """The state's layer axis over "pipe" (and, with ``tp``, the heads over
    "model" as ``sharded.state_pspecs``); lengths replicated."""
    plane = ("pipe", None, None, "model") if tp else ("pipe",)
    scale = ("pipe", None, "model", None) if tp else ("pipe",)

    def kv_spec(t: QuantizedKV) -> QuantizedKV:
        return QuantizedKV(
            full=plane, msb=plane if t.msb is not None else None,
            scale=scale, lsb2=plane if t.lsb2 is not None else None)

    return DecodeState(
        cache=LayerKVCache(k=kv_spec(state.cache.k),
                           v=kv_spec(state.cache.v)),
        importance=scale,
        lengths=(),
        layer_lengths=("pipe",),
        head_mask=("pipe", "model") if tp else ("pipe",),
        requant_events=(),
        quant_bits=("pipe",),
    )


def _rows(st: DecodeState, rows: slice) -> DecodeState:
    """Views of batch rows of a stage's state (the cache planes, scales,
    importance and lengths), which the layers update in place."""
    def q(t: QuantizedKV) -> QuantizedKV:
        return QuantizedKV(*(None if x is None else x[:, rows] for x in t))
    return st._replace(
        cache=LayerKVCache(k=q(st.cache.k), v=q(st.cache.v)),
        importance=st.importance[:, rows], lengths=st.lengths[rows],
        layer_lengths=st.layer_lengths[:, rows])


class PipelineEngine:
    """P-stage pipelined decode over a ("pipe", "model") mesh of processes
    (a "model" axis of 1 is JAX's ("pipe",) mesh).

    ``microbatches`` M > 1 interleaves M batch slices through the stages
    (GPipe schedule over M + P - 1 ticks): while microbatch m is in stage
    p, microbatch m+1 occupies stage p-1, so the bubble fraction is
    (P-1)/(M+P-1) instead of the single-microbatch (P-1)/P.
    """

    def __init__(self, cfg: SpAttenConfig, mesh: Mesh,
                 microbatches: int = 1):
        cfg.validate()
        if tuple(mesh.axis_names) != ("pipe", "model"):
            raise ValueError("PipelineEngine expects a ('pipe', 'model') "
                             "mesh")
        if mesh.coords is None:
            raise ValueError("this rank lies outside the mesh")
        if cfg.engine.max_batch_size % microbatches:
            raise ValueError("microbatches must divide max_batch_size")
        self.microbatches = microbatches
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device
        self.stages = mesh.shape["pipe"]
        self.stage = mesh.coords["pipe"]
        self.tp = mesh.shape["model"]
        self.tp_group = mesh.group("model") if self.tp > 1 else None
        self.pipe_group = mesh.group("pipe")
        self._req_group = (mesh.group("pipe") if self.tp == 1
                           else mesh.group("pipe", "model"))
        lcfg = pipeline_local_config(cfg, self.stages)
        if self.tp > 1:
            lcfg = local_config(lcfg, mesh)
        self.lcfg = lcfg

    def shard_params(self, params: Any) -> Any:
        """This stage's (and model rank's) slice of a global parameter
        tree, on its device."""
        return shard_tree(params,
                          pipeline_param_pspecs(params, tp=self.tp > 1),
                          self.mesh)

    def init_params(self, generator: torch.Generator | int = 0,
                    dtype: torch.dtype = torch.bfloat16) -> Any:
        """This rank's slice of ``transformer.init_params(cfg.model,
        generator, dtype)``, drawn on its device without the whole tree."""
        def spec(name):
            return (("pipe",) + LAYER_RULES[name][1:] if self.tp > 1
                    else ("pipe",))
        return transformer.init_params(
            self.cfg.model, generator, dtype, self.device,
            keep=param_keeper(self.mesh, self.cfg.model.num_layers, spec))

    def init_sharded_state(self, batch: Optional[int] = None) -> DecodeState:
        """This rank's block of an empty global decode state (the global
        model's layer bits cut to the stage's layers)."""
        b = batch if batch is not None else self.cfg.engine.max_batch_size
        st = init_state(self.lcfg, b, device=self.device)
        n = self.lcfg.model.num_layers
        bits = self.cfg.quant.resolved_layer_bits(self.cfg.model.num_layers)
        return st._replace(quant_bits=torch.tensor(
            bits[self.stage * n:(self.stage + 1) * n], dtype=torch.int32,
            device=self.device))

    def _layers(self, params, sub: DecodeState, x: torch.Tensor):
        return transformer.run_layers(
            params["layers"], self.lcfg, sub, x,
            layer_offset=self.stage * self.lcfg.model.num_layers,
            tp_group=self.tp_group)

    def _finish(self, state: DecodeState, logits: torch.Tensor,
                requants: torch.Tensor, s: int):
        """The last stage's logits on every rank (an all-reduce over "pipe"
        of the other stages' zeros, JAX's masked psum) and the requant
        count summed over the mesh."""
        all_reduce(logits, self.pipe_group)
        total = all_reduce(requants.to(torch.int32).reshape(()).clone(),
                           self._req_group)
        return logits, state._replace(
            lengths=state.lengths + s,
            requant_events=state.requant_events + total)

    def _local_step(self, params, state: DecodeState, tokens: torch.Tensor):
        """tokens [B, S] (the same on every rank) -> logits of the LAST
        query position [B, V] (on every rank) + this rank's state."""
        s = tokens.shape[1]
        state, _ = gen.maybe_prune(self.lcfg, state, s)
        x, _ = transformer.embed_tokens(params, self.lcfg, state, tokens)
        if self.stage > 0:
            recv(x, self.stage - 1, self.pipe_group)
        x, layer_lengths, requants, _ = self._layers(params, state, x)
        if self.stage < self.stages - 1:
            send(x, self.stage + 1, self.pipe_group)
            logits = torch.zeros((x.shape[0], self.lcfg.model.vocab_size),
                                 dtype=torch.float32, device=self.device)
        else:
            logits = transformer.lm_head(params, self.lcfg,
                                         x[:, -1:])[:, 0]
        state = state._replace(layer_lengths=layer_lengths)
        return self._finish(state, logits, requants.sum(), s)

    def _local_step_micro(self, params, state: DecodeState,
                          tokens: torch.Tensor):
        """The GPipe schedule: the batch splits into M slices that flow
        through the P stages over M + P - 1 ticks; at tick t stage s runs
        slice t - s (when there is one), handing its activations on.
        Output logits [B, V] (last query position)."""
        M = self.microbatches
        b, s = tokens.shape
        if b % M:
            raise ValueError(f"batch {b} must divide microbatches {M}")
        bm = b // M
        state, _ = gen.maybe_prune(self.lcfg, state, s)
        x_all, _ = transformer.embed_tokens(params, self.lcfg, state,
                                            tokens)
        logits_all = torch.zeros((b, self.lcfg.model.vocab_size),
                                 dtype=torch.float32, device=self.device)
        requants = torch.zeros((), dtype=torch.int32, device=self.device)
        for t in range(M + self.stages - 1):
            m = t - self.stage                # this stage's microbatch
            if not 0 <= m < M:
                continue
            rows = slice(m * bm, (m + 1) * bm)
            x_in = x_all[rows]
            if self.stage > 0:
                x_in = recv(torch.empty_like(x_in), self.stage - 1,
                            self.pipe_group)
            sub = _rows(state, rows)
            x_out, ll, req, _ = self._layers(params, sub, x_in)
            state.layer_lengths[:, rows] = ll
            requants = requants + req.sum()
            if self.stage < self.stages - 1:
                send(x_out, self.stage + 1, self.pipe_group)
            else:
                logits_all[rows] = transformer.lm_head(
                    params, self.lcfg, x_out[:, -1:])[:, 0]
        return self._finish(state, logits_all, requants, s)

    def step_fn(self, seq_len: int):
        """(params, state, tokens [B, seq_len]) -> (logits [B, V], state);
        the schedule by ``microbatches``."""
        del seq_len                            # eager: one step for all
        return (self._local_step if self.microbatches == 1
                else self._local_step_micro)

    def generate(self, params, prompt, max_new_tokens: int) -> torch.Tensor:
        """Greedy pipelined generation (prefill chunks + decode); the
        tokens [B, new] on every rank."""
        prompt = torch.as_tensor(prompt).to(self.device, torch.int64)
        b, prompt_len = prompt.shape
        state = self.init_sharded_state(b)
        chunk = self.cfg.engine.prefill_chunk
        pos, logits = 0, None
        while pos < prompt_len:
            n = min(chunk, prompt_len - pos)
            logits, state = self.step_fn(n)(params, state,
                                            prompt[:, pos:pos + n])
            pos += n
        token = torch.argmax(logits, dim=-1).to(torch.int32)
        outs = []
        for _ in range(max_new_tokens):
            outs.append(token)
            logits, state = self.step_fn(1)(params, state, token[:, None])
            token = torch.argmax(logits, dim=-1).to(torch.int32)
        return torch.stack(outs, dim=1)
