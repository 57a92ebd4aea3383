"""Decoder transformer with a SpAtten attention core (port of
``spatten_tpu/models/transformer.py``).

One generic decoder covers Llama-class (RMSNorm, RoPE, SwiGLU, GQA) and
GPT-2-class (LayerNorm, learned positions, GELU) models.  Parameters are a
plain dict with layer-stacked tensors ``[L, ...]`` laid out as in the JAX
package (``x @ w`` with ``w`` [in, out]).  The forward pass loops over
layers in Python:

* a single-token step (``s == 1``) that ``decode_uses_kernel`` admits
  takes the fused decode kernel K1 (``ops/fused_decode``), which appends
  to and reads the stacked cache in place, one call per layer with the
  layer's capacity rung (``token_pruning.layer_capacity_groups``) and the
  serving flags of ``QuantConfig``;
* a prompt chunk (``s > 1``), or a step the gate sends elsewhere
  (``use_pallas=False``, "read" rope mode, or on the card a fused lane
  width ``Hkv * D`` that is not a multiple of 128, as in the JAX gate),
  appends with ``append_tokens`` and attends with ``prefill_attention``
  (chunks) or the reference (single tokens).

The cache planes and the importance accumulator of the state are updated
IN PLACE: ``forward`` consumes its input state.

``compact_head_params`` gathers each layer's kept heads out of the
attention projections (permanent head pruning); ``forward(head_compact=
...)`` then computes q/k/v on the compact width and scatters them into
their physical head slots, so dead heads get exact zeros.

Tensor parallelism (``tp_group``, a process group of ``parallel.mesh``):
the parameters and ``cfg`` describe this rank's heads and MLP columns,
and the o_proj and MLP outputs are summed over the group
(``mesh.all_reduce``) before the replicated biases are added, where the
JAX model psums over its ``tp_axis`` (in the activations' dtype, as
the psum adds them).  ``layer_offset``: the global index
of local layer 0 (a pipeline stage), read by the per-layer attention
scale.  With neither, every path is the code it was.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from spatten_tpu_torch.config import ModelConfig, SpAttenConfig
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.kv_cache import append_tokens
from spatten_tpu_torch.engine.state import DecodeState
from spatten_tpu_torch.models import moe
from spatten_tpu_torch.models.weight_quant import (
    is_quantized, matmul as _mm, matmul_t as _mm_t, take_rows as _take_rows,
)
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.ops.attention_ref import spatten_attention_reference
from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
from spatten_tpu_torch.ops.prefill_attention import prefill_attention
from spatten_tpu_torch.parallel.mesh import all_reduce
from spatten_tpu_torch.pruning.token_pruning import (
    layer_budgets_static, layer_capacity_groups,
)
from spatten_tpu_torch.utils.profiling import OFF, tracer

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, generator: torch.Generator | int = 0,
                dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda", keep=None) -> Params:
    """Random parameters: dense weights ~ N(0, 1/fan_in), norms at 1.

    ``generator`` is a ``torch.Generator`` on ``device`` or an int seed.
    Each layer's slice is drawn separately, so the f32 transient stays
    one layer's matrix (Llama-2-7B: 13.5 GB of bf16 weights).

    ``keep(name, layer, t)``: a rank's part of the tree (a shard of a
    model too large for one card), given each leaf's layer slice
    (``layer`` its index, None for an unstacked leaf) as the whole tree
    would hold it; it returns the part to keep, or None to drop a layer.
    The random stream is drawn in full, so the parts are those of the
    whole tree from the same seed."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if cfg.latent:
        if keep is not None:
            raise NotImplementedError("a rank's part of a DeepSeek-V2 tree")
        return _init_deepseek_v2(cfg, generator, dtype, dev)
    m = cfg
    L, D, I = m.num_layers, m.hidden_size, m.intermediate_size
    hq, hkv, dh = m.num_heads, m.num_kv_heads, m.head_dim

    def kept(name, parts):
        parts = [t for t in parts if t is not None]
        return torch.stack(parts) if parts else None

    def dense(name, shape, fan_in, stacked=True):
        if keep is not None:
            def draw(part_shape, layer):
                t = (torch.randn(part_shape, generator=generator, device=dev)
                     / math.sqrt(fan_in)).to(dtype)
                t = keep(name, layer, t)
                return None if t is None else t.contiguous()
            if not stacked:
                return draw(shape, None)
            return kept(name, [draw(shape[1:], l) for l in range(shape[0])])
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in (out if stacked else [out]):
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev) / math.sqrt(fan_in))
        return out

    def const(name, shape, value, stacked=True):
        if keep is not None:
            t = torch.full(shape[1:] if stacked else shape, value,
                           dtype=dtype, device=dev)
            if not stacked:
                return keep(name, None, t)
            return kept(name, [keep(name, l, t) for l in range(shape[0])])
        return torch.full(shape, value, dtype=dtype, device=dev)

    layers = {
        "attn_norm_w": const("attn_norm_w", (L, D), 1.0),
        "wq": dense("wq", (L, D, hq * dh), D),
        "wk": dense("wk", (L, D, hkv * dh), D),
        "wv": dense("wv", (L, D, hkv * dh), D),
        "wo": dense("wo", (L, hq * dh, D), hq * dh),
        "mlp_norm_w": const("mlp_norm_w", (L, D), 1.0),
        "w_up": dense("w_up", (L, D, I), D),
        "w_down": dense("w_down", (L, I, D), I),
    }
    if m.activation == "silu":
        layers["w_gate"] = dense("w_gate", (L, D, I), D)
    if m.layernorm_kind == "layernorm":
        layers["attn_norm_b"] = const("attn_norm_b", (L, D), 0.0)
        layers["mlp_norm_b"] = const("mlp_norm_b", (L, D), 0.0)
    if m.use_qkv_bias:
        layers["bq"] = const("bq", (L, hq * dh), 0.0)
        layers["bk"] = const("bk", (L, hkv * dh), 0.0)
        layers["bv"] = const("bv", (L, hkv * dh), 0.0)
        layers["bo"] = const("bo", (L, D), 0.0)
    if m.use_mlp_bias:
        layers["b_up"] = const("b_up", (L, I), 0.0)
        layers["b_down"] = const("b_down", (L, D), 0.0)
    params: Params = {
        "embed": dense("embed", (m.vocab_size, D), D, stacked=False),
        "layers": layers,
        "final_norm_w": const("final_norm_w", (D,), 1.0, stacked=False),
    }
    if m.layernorm_kind == "layernorm":
        params["final_norm_b"] = const("final_norm_b", (D,), 0.0,
                                       stacked=False)
    if m.use_abs_pos_emb:
        params["wpe"] = dense("wpe", (m.max_position_embeddings, D), D,
                              stacked=False)
    if not m.tie_word_embeddings:
        params["lm_head"] = dense("lm_head", (D, m.vocab_size), D,
                                  stacked=False)
    return params


def _init_deepseek_v2(m, generator: torch.Generator, dtype: torch.dtype,
                      dev: torch.device) -> Params:
    """Random DeepSeek-V2 parameters (``init_params`` for a
    ``DeepseekV2Config``), each leaf's layer slices drawn in turn.

    ``layers`` holds the attention leaves stacked over every layer:
    ``wq`` [D, H*(nope+rope)], ``wkv_a`` [D, R+rope], ``kv_a_norm_w``
    [R], ``w_uk`` [H, nope, R] and ``w_uv`` [H, R, v] (the published
    ``kv_b_proj``'s key and value rows of each head), ``wo`` [H*v, D];
    ``layers["dense"]`` the leading dense layers' SwiGLU (``w_gate``,
    ``w_up``, ``w_down``); ``layers["moe"]`` the expert layers' router
    [D, E], experts ``w_gate_up`` [E, 2I, D] and ``w_down`` [E, D, I],
    and the shared experts as one SwiGLU (``shared_gate``, ``shared_up``,
    ``shared_down``) of width ``n_shared_experts * I``."""
    L, D, H = m.num_layers, m.hidden_size, m.num_heads
    R, nope, rope, vd = (m.kv_lora_rank, m.qk_nope_head_dim,
                         m.qk_rope_head_dim, m.v_head_dim)
    k, Lm, E = m.first_k_dense_replace, m.moe_layers, m.n_routed_experts
    I, Im = m.intermediate_size, m.moe_intermediate_size
    Is = m.n_shared_experts * Im

    def dense(shape, fan_in):
        out = torch.empty(shape, dtype=dtype, device=dev)
        for part in out:
            part.copy_(torch.randn(part.shape, generator=generator,
                                   device=dev) / math.sqrt(fan_in))
        return out

    def ones(shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    layers = {
        "attn_norm_w": ones((L, D)),
        "wq": dense((L, D, H * (nope + rope)), D),
        "wkv_a": dense((L, D, R + rope), D),
        "kv_a_norm_w": ones((L, R)),
        "w_uk": dense((L, H, nope, R), R),
        "w_uv": dense((L, H, R, vd), R),
        "wo": dense((L, H * vd, D), H * vd),
        "mlp_norm_w": ones((L, D)),
        "dense": {"w_gate": dense((k, D, I), D), "w_up": dense((k, D, I), D),
                  "w_down": dense((k, I, D), I)},
        "moe": {"router": dense((Lm, D, E), D),
                "w_gate_up": dense((Lm, E, 2 * Im, D), D),
                "w_down": dense((Lm, E, D, Im), Im),
                "shared_gate": dense((Lm, D, Is), D),
                "shared_up": dense((Lm, D, Is), D),
                "shared_down": dense((Lm, Is, D), Is)},
    }
    def table(shape):                     # unstacked, fan-in the hidden size
        return (torch.randn(shape, generator=generator, device=dev)
                / math.sqrt(D)).to(dtype)

    return {"embed": table((m.vocab_size, D)), "layers": layers,
            "final_norm_w": ones((D,)), "lm_head": table((D, m.vocab_size))}


def num_params(params: Params) -> int:
    """The number of parameters in a tree (nested dicts of tensors)."""
    if isinstance(params, torch.Tensor):
        return params.numel()
    return sum(num_params(v) for v in params.values())


def compact_head_params(params: Params, cfg: SpAttenConfig,
                        head_mask: torch.Tensor) -> dict:
    """Physically compact the attention projections to the KEPT heads.

    Permanent head pruning (``head_update_interval == 0``: the mask is
    derived once, after prefill): gather each layer's kept head columns
    of wq/wk/wv (and the qkv biases) and kept rows of wo, so decode
    streams only live-head weight bytes.  The KV cache keeps its full
    head layout.  Returns {"layers": compacted stacked leaves, "kept_q":
    int64 [L, kq], "kept_kv": int64 [L, kkv]} for
    ``forward(head_compact=...)``; outputs equal the masked forward.
    Not for a latent (MLA) cache: DeepSeek-V2's query heads share one
    cached row, and its projections are not laid out per kv head."""
    m, p = cfg.model, cfg.pruning
    if m.latent:
        raise NotImplementedError(
            f"compact_head_params: {m.model_type} caches a latent row "
            "(MLA); its heads are pruned by the head mask alone")
    L, hq, hkv, dh = m.num_layers, m.num_heads, m.num_kv_heads, m.head_dim
    group = hq // hkv
    kg = min(p.head_keep, hkv)
    dev = head_mask.device
    gmask = head_mask.reshape(L, hkv, group).any(-1)           # [L, Hkv]
    # kept kv-group indices in physical order (the scores are distinct,
    # so the top-k has no ties)
    score = gmask.to(torch.int64) * (2 * hkv) - torch.arange(hkv, device=dev)
    kept_kv = torch.sort(torch.topk(score, kg, dim=-1).indices,
                         dim=-1).values                         # [L, kg]
    kept_q = (kept_kv[:, :, None] * group + torch.arange(
        group, device=dev)[None, None, :]).reshape(L, kg * group)

    def lanes(idx):                       # [L, k] -> [L, k*dh]
        return (idx[:, :, None] * dh + torch.arange(
            dh, device=dev)[None, None, :]).reshape(idx.shape[0], -1)

    def g_out(w, li):                     # gather output-channel lanes
        if is_quantized(w):
            return {"qw": torch.take_along_dim(w["qw"], li[:, None, :], 2),
                    "ws": torch.take_along_dim(w["ws"], li, 1)}
        return torch.take_along_dim(w, li[:, None, :], 2)

    def g_in(w, li):                      # gather input-row lanes (wo)
        if is_quantized(w):
            return {"qw": torch.take_along_dim(w["qw"], li[:, :, None], 1),
                    "ws": w["ws"]}
        return torch.take_along_dim(w, li[:, :, None], 1)

    lq, lkv = lanes(kept_q), lanes(kept_kv)
    layers = dict(params["layers"])
    layers["wq"] = g_out(layers["wq"], lq)
    layers["wk"] = g_out(layers["wk"], lkv)
    layers["wv"] = g_out(layers["wv"], lkv)
    layers["wo"] = g_in(layers["wo"], lq)
    for bn, li in (("bq", lq), ("bk", lkv), ("bv", lkv)):
        if bn in layers:
            layers[bn] = torch.take_along_dim(layers[bn], li, 1)
    return {"layers": layers, "kept_q": kept_q, "kept_kv": kept_kv}


def _norm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
          kind: str, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + eps) * w.to(torch.float32)
        if b is not None:
            out = out + b.to(torch.float32)
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def _biased(y: torch.Tensor, lp: Params, name: str) -> torch.Tensor:
    """y + lp[name] when the model has that bias."""
    return y + lp[name] if name in lp else y


def _mlp(x: torch.Tensor, lp: Params, activation: str) -> torch.Tensor:
    """Up/gate/down MLP without the down bias (added by the caller)."""
    if activation == "silu":
        up = _mm(x, lp["w_up"])
        if "b_up" in lp:
            up = up + lp["b_up"]
        return _mm(F.silu(_mm(x, lp["w_gate"])) * up, lp["w_down"])
    if activation == "gelu":
        hdn = _mm(x, lp["w_up"])
        if "b_up" in lp:
            hdn = hdn + lp["b_up"]
        return _mm(F.gelu(hdn, approximate="tanh"), lp["w_down"])
    raise ValueError(activation)


class StepAux(NamedTuple):
    """Per-call aggregate pruning/quant telemetry."""

    requant_events: torch.Tensor   # int32 [] (layer, batch, kv head) requants
    max_probs: torch.Tensor        # f32 [L, B, Hkv]
    layer_requants: torch.Tensor   # int32 [L] requants by layer
    # rows each expert received, int32 [expert layers, E], for a model
    # with expert layers (DeepSeek-V2) while the tracer is on (a graphed
    # prefill chunk's ``moe.experts_hit``); else None
    expert_counts: Optional[torch.Tensor] = None


def embed_tokens(params: Params, cfg: SpAttenConfig, state: DecodeState,
                 tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Token (+ absolute position) embedding.  Returns (x, positions)."""
    s = tokens.shape[1]
    x = _take_rows(params["embed"], tokens)                  # [B, S, D]
    positions = state.lengths[:, None] + torch.arange(
        s, device=tokens.device)[None, :]
    if cfg.model.use_abs_pos_emb:
        x = x + _take_rows(params["wpe"], positions)
    return x, positions


def lm_head(params: Params, cfg: SpAttenConfig, x: torch.Tensor
            ) -> torch.Tensor:
    m = cfg.model
    x = _norm(x, params["final_norm_w"], params.get("final_norm_b"),
              m.layernorm_kind, m.norm_eps)
    if m.tie_word_embeddings:
        logits = _mm_t(x, params["embed"])
    else:
        logits = _mm(x, params["lm_head"])
    return logits.to(torch.float32)


def v_keep_budgets(cfg: SpAttenConfig, capacity: int) -> tuple[int, ...]:
    """Per-layer value fetch budgets relative to each layer's steady-state
    key budget (start + cascade budget + recent); (0,) when off."""
    p, m = cfg.pruning, cfg.model
    if not p.enable_v_pruning:
        return (0,)
    if p.enable_token_pruning:
        kb_l = [p.start_size + bl + p.recent_size
                for bl in layer_budgets_static(p, m.num_layers)]
    else:
        kb_l = [capacity] * m.num_layers
    return tuple(max(p.v_block_size, int(p.v_keep_ratio * kb)) for kb in kb_l)


def _layer_leaf(w, l: int):
    """Layer ``l`` of a stacked leaf (a tensor or a quantized dict)."""
    if isinstance(w, dict):
        return {k: v[l] for k, v in w.items()}
    return w[l]


def decode_uses_kernel(cfg: SpAttenConfig, device_type: str) -> bool:
    """Whether a single-token step on a ``device_type`` tensor goes through
    K1, decided from the configuration alone by the JAX gate's terms: K1
    computes no RoPE (so "read" rope mode keeps the reference path), its
    6-bit append needs capacity >= 32, and on the card the fused lane width
    ``Hkv * D`` must be a multiple of 128 (the reference's ``(hkv*dh) % 128
    == 0 or on_cpu``) unless the cache holds a latent row (DeepSeek-V2's
    576 lanes, a term of the port's own).  On the CPU the wrapper runs K1's plain version,
    which takes every shape.  A shape the gate admits and K1 does not take
    (``fused_decode.k1_shape_error``) raises in the wrapper."""
    m, q, e = cfg.model, cfg.quant, cfg.engine
    return (e.use_pallas and (m.use_abs_pos_emb or e.rope_mode == "cached")
            and (m.num_kv_heads * m.head_dim % 128 == 0
                 or device_type != "cuda"
                 # a latent row (MLA): one kv head of kv_lora_rank + rope
                 # lanes, which K1 reads in lane pieces
                 or m.latent)
            # the 6-bit path's 2-bit append needs cap >= 32
            and not (q.needs_lsb2 and e.cache_capacity < 32))


def _accumulate_rows(imp: torch.Tensor, delta: torch.Tensor,
                     lengths: torch.Tensor, alive: Optional[torch.Tensor],
                     ema: float) -> None:
    """K1's importance update, per query row, in place: ``imp`` [B, Hq, C]
    (a latent cache's accumulator), ``delta`` [B, Hq, rung] this step's
    per-row delta (zero past each length), ``lengths`` [B] with the
    appended token: on the live columns of each alive row (``alive``
    [Hq] bool, None for all) the appended slot is reset, then imp <- ema
    * imp + delta; every other entry keeps its bytes, as K1 leaves a dead
    head group's."""
    rung = delta.shape[-1]
    cur = imp[..., :rung]
    cols = torch.arange(rung, device=imp.device)
    at = (cols[None] == (lengths - 1)[:, None])[:, None]     # [B, 1, rung]
    upd = (cols[None] < lengths[:, None])[:, None]
    if alive is not None:
        upd = upd & alive[None, :, None]
    curf = cur.to(torch.float32)
    new = torch.where(at, 0.0, curf) * ema + delta
    cur.copy_(torch.where(upd, new, curf).to(cur.dtype))


_MLP_GROUPS = ("dense", "moe")      # DeepSeek-V2's MLP leaves, by layer kind


def run_layers(layer_params: Params, cfg: SpAttenConfig, state: DecodeState,
               x: torch.Tensor,
               rope_tables: tuple[torch.Tensor, torch.Tensor] | None = None,
               head_kept: tuple[torch.Tensor, torch.Tensor] | None = None,
               layer_offset: int = 0, tp_group=None,
               expert_hits: list | None = None):
    """Run x [B, S, D] through every layer, appending the S tokens to each
    layer's cache IN PLACE (the state's cache and importance are
    consumed).  Returns (x, new_layer_lengths, requants [L], max_probs
    [L, B, Hkv]).  Each layer's token slots come from its own length.

    ``head_kept``: (kept_q [L, kq], kept_kv [L, kkv]) when
    ``layer_params`` are the compacted leaves of ``compact_head_params``
    (decode only).  ``layer_offset``: the global index of local layer 0
    (the per-layer attention scale reads it); ``tp_group``: the process
    group that the o_proj and MLP partial sums are reduced over.

    A DeepSeek-V2 model (``cfg.model.latent``) caches one latent row a
    token and layer: the query is ``[q_nope W_UK^T || rope(q_pe)]`` per
    head, the row ``[norm(c_kv) || rope(k_pe)]`` goes into the K and the V
    plane alike (the V plane's lanes past ``kv_lora_rank`` are never read
    out), the attention is K1 (decode) or ``prefill_attention`` at one kv
    head of group ``num_heads``, with one importance row per query head,
    and the output's first ``kv_lora_rank`` lanes go through ``W_UV`` and
    ``wo`` (span ``mla.attention``); the MLP is dense in the first
    ``first_k_dense_replace`` layers and routed experts plus the shared
    ones after (``models/moe.py``, span ``moe.layer``).  ``expert_hits``:
    a list that receives each expert layer's per-expert row counts."""
    m, p, q, e = cfg.model, cfg.pruning, cfg.quant, cfg.engine
    b, s = x.shape[:2]
    hq, hkv, dh = m.num_heads, m.num_kv_heads, m.head_dim
    cap = state.capacity
    if rope_tables is None:
        rope_tables = rope_ops.model_rope_table(m, cap, x.device)
    cos, sin = rope_tables
    base_scale = m.softmax_scale if m.latent else 1.0 / math.sqrt(dh)
    v_keep_layers = v_keep_budgets(cfg, cap)
    track_importance = p.enable_token_pruning or p.enable_head_pruning
    accum = track_importance and p.cascade_accumulate
    use_kernel = s == 1 and decode_uses_kernel(cfg, x.device.type)
    if head_kept is not None and not use_kernel:
        raise NotImplementedError(
            "head-compacted projections are a decode-kernel-path feature "
            "(prefill derives the mask, so it never runs compacted)")
    requant_threshold = (q.requant_threshold
                         if (q.enabled and q.enable_requant) else 0.0)
    ar = torch.arange(s, device=x.device)

    def qkv(x, lp, lengths_l, layer_idx, kept=None):
        """Norm, projections and RoPE: (q, k, v) [B, H, S, D], sm_scale.
        ``kept``: (kept_q_l, kept_kv_l) for compacted projections --
        computed on the compact width, then scattered into the physical
        head slots (dead heads get exact zeros)."""
        h = _norm(x, lp["attn_norm_w"], lp.get("attn_norm_b"),
                  m.layernorm_kind, m.norm_eps)
        qh = _biased(_mm(h, lp["wq"]), lp, "bq")
        kh = _biased(_mm(h, lp["wk"]), lp, "bk")
        vh = _biased(_mm(h, lp["wv"]), lp, "bv")
        nq = hq if kept is None else kept[0].shape[0]
        nkv = hkv if kept is None else kept[1].shape[0]
        qh = qh.reshape(b, s, nq, dh).transpose(1, 2)
        kh = kh.reshape(b, s, nkv, dh).transpose(1, 2)
        vh = vh.reshape(b, s, nkv, dh).transpose(1, 2)
        if kept is not None:
            def scatter(t, heads, idx):
                full = torch.zeros((b, heads, s, dh), dtype=t.dtype,
                                   device=t.device)
                full[:, idx] = t
                return full
            qh = scatter(qh, hq, kept[0])
            kh = scatter(kh, hkv, kept[1])
            vh = scatter(vh, hkv, kept[1])
        pos_l = torch.clamp(lengths_l[:, None] + ar[None, :], max=cap - 1)
        if not m.use_abs_pos_emb:
            c = cos[pos_l][:, None]                       # [B, 1, S, dh]
            sn = sin[pos_l][:, None]
            qh = (qh * c + rope_ops.rotate_half(qh) * sn).to(qh.dtype)
            if e.rope_mode == "cached":
                kh = (kh * c + rope_ops.rotate_half(kh) * sn).to(kh.dtype)
        sm_scale = base_scale
        if m.use_attn_scale_by_layer:
            sm_scale = base_scale / (layer_idx + layer_offset + 1.0)
        return qh, kh, vh, pos_l, sm_scale

    def mla_qkv(x, lp, lengths_l):
        """DeepSeek-V2's projections: (the absorbed queries [B, Hq, S,
        R + rope], the latent rows [B, 1, S, R + rope], positions)."""
        nope, rope, rank = m.qk_nope_head_dim, m.qk_rope_head_dim, \
            m.kv_lora_rank
        h = _norm(x, lp["attn_norm_w"], None, "rmsnorm", m.norm_eps)
        qa = _mm(h, lp["wq"]).reshape(b, s, hq, nope + rope)
        kv = _mm(h, lp["wkv_a"])                          # [B, S, R + rope]
        c_kv = _norm(kv[..., :rank], lp["kv_a_norm_w"], None, "rmsnorm",
                     m.norm_eps)
        pos_l = torch.clamp(lengths_l[:, None] + ar[None, :], max=cap - 1)
        c = cos[pos_l][:, :, None]                        # [B, S, 1, rope]
        sn = sin[pos_l][:, :, None]

        def turn(t):
            t = rope_ops.deinterleave(t)
            return (t * c + rope_ops.rotate_half(t) * sn).to(t.dtype)
        q_pe = turn(qa[..., nope:])
        k_pe = turn(kv[:, :, None, rank:])[:, :, 0]       # [B, S, rope]
        # W_UK folded into the query: q_nope . (c_kv W_UK_h) = (q_nope
        # W_UK_h^T) . c_kv
        q_lat = torch.einsum("bshn,hnc->bshc", qa[..., :nope], lp["w_uk"])
        qh = torch.cat([q_lat, q_pe], dim=-1).transpose(1, 2)
        row = torch.cat([c_kv, k_pe], dim=-1)[:, None]
        return qh, row, pos_l

    def mla_out(attn_out, lp):
        """The latent output's first R lanes through W_UV, then wo."""
        o = attn_out[..., :m.kv_lora_rank].to(x.dtype)    # [B, Hq, S, R]
        o = torch.einsum("bhsc,hcv->bshv", o, lp["w_uv"]).reshape(b, s, -1)
        return _mm(o, lp["wo"])

    def mlp_block(x, l, lp):
        """The residual after DeepSeek-V2's MLP: dense SwiGLU in the
        leading layers, else routed experts plus the shared ones."""
        h2 = _norm(x, lp["mlp_norm_w"], None, "rmsnorm", m.norm_eps)
        kd = m.first_k_dense_replace
        if l < kd:
            dp = {k: _layer_leaf(v, l) for k, v in
                  layer_params["dense"].items()}
            return x + _mlp(h2, dp, "silu")
        mp = {k: _layer_leaf(v, l - kd) for k, v in
              layer_params["moe"].items()}
        with tracer.span("moe.layer", tokens=b * s) as span:
            hf = h2.reshape(b * s, -1)
            weights, idx = moe.route(
                hf, mp["router"], m.num_experts_per_tok,
                norm_topk=m.norm_topk_prob, scale=m.routed_scaling_factor)
            y, offs = moe.experts(hf, mp["w_gate_up"], mp["w_down"],
                                  weights, idx)
            y = y + _mlp(hf, {"w_gate": mp["shared_gate"],
                              "w_up": mp["shared_up"],
                              "w_down": mp["shared_down"]}, "silu")
            if tracer.on:
                hits = moe.counts(offs)
                span.note(experts_hit=hits)
                if expert_hits is not None:
                    expert_hits.append(hits)
        return x + y.reshape(b, s, -1)

    def out_mlp(x, lp, attn_out, kept_q=None):
        if kept_q is not None:
            # head-compacted o_proj: the pruned heads' rows were zeros
            attn_out = attn_out[:, kept_q]
        o = attn_out.to(x.dtype).transpose(1, 2).reshape(b, s, -1)
        x = x + _biased(all_reduce(_mm(o, lp["wo"]), tp_group), lp, "bo")
        h2 = _norm(x, lp["mlp_norm_w"], lp.get("mlp_norm_b"),
                   m.layernorm_kind, m.norm_eps)
        return _biased(x + all_reduce(_mlp(h2, lp, m.activation), tp_group),
                       lp, "b_down")

    # per-layer capacity rungs: K1 is sized to each group's rung
    rungs = [cap] * m.num_layers
    for ga, gb, rung in layer_capacity_groups(cfg):
        rungs[ga:gb] = [rung] * (gb - ga)
    requants, max_probs = [], []
    for l in range(m.num_layers):
        lp = {k: _layer_leaf(v, l) for k, v in layer_params.items()
              if k not in _MLP_GROUPS}
        lengths_l = state.layer_lengths[l]
        kept = None if head_kept is None else (head_kept[0][l],
                                               head_kept[1][l])
        with (tracer.span("mla.attention") if m.latent else OFF):
            if m.latent:
                qh, kh, pos_l = mla_qkv(x, lp, lengths_l)
                vh, sm_scale = kh, base_scale
            else:
                qh, kh, vh, pos_l, sm_scale = qkv(x, lp, lengths_l, l, kept)
            common = dict(
                requant_threshold=requant_threshold, quant_enabled=q.enabled,
                v_block_size=p.v_block_size,
                head_mask=state.head_mask[l] if p.enable_head_pruning
                else None,
                importance_kind=p.importance_kind)
            if use_kernel:
                q_kernel = qh * (sm_scale / base_scale) \
                    if m.use_attn_scale_by_layer else qh
                # a latent cache keeps an importance row per query head:
                # K1 hands this step's per-row delta back (delta mode)
                rows_kw = dict(per_row_importance=True) if m.latent else {}
                attn_out, stats, _, _ = fused_decode_attention(
                    q_kernel, state.cache.k, state.cache.v, kh, vh,
                    lengths_l + s, sm_scale=base_scale,
                    importance_in=(state.importance
                                   if accum and not m.latent else None),
                    layer=l,
                    quant_bits=(state.quant_bits
                                if q.enabled and q.layer_bits is not None
                                else None),
                    quantize_queries=q.quantize_queries, pv_int8=q.pv_int8,
                    probs_bf16=q.probs_bf16,
                    cap_override=rungs[l] if rungs[l] < cap else None,
                    track_importance=track_importance,
                    importance_ema=p.importance_ema,
                    v_keep=v_keep_layers, **rows_kw, **common)
                if track_importance and accum and m.latent:
                    _accumulate_rows(state.importance[l],
                                     stats.importance_delta, lengths_l + s,
                                     common["head_mask"], p.importance_ema)
                elif track_importance and not accum:
                    # a rung-sized delta: columns past the rung are dead
                    delta = stats.importance_delta
                    state.importance[l].zero_()
                    state.importance[l, ..., :delta.shape[-1]] = delta.to(
                        state.importance.dtype)
            else:
                layer_cache = append_tokens(state.cache.layer(l), kh, vh,
                                            lengths_l)
                kwargs = dict(common, v_keep=v_keep_layers[
                    min(l, len(v_keep_layers) - 1)])
                kwargs["use_rope"] = (not m.use_abs_pos_emb
                                      and e.rope_mode == "read")
                if m.latent:
                    kwargs["per_row_importance"] = True
                if q.enabled and q.layer_bits is not None:
                    with tracer.sync("model.pass1_bits"):
                        kwargs["pass1_bits"] = int(state.quant_bits[l])
                if s > 1:
                    if e.prefill_fp_score:
                        # score the prompt at full precision; the quantized
                        # planes and exact importance still build
                        kwargs.update(quant_enabled=False,
                                      requant_threshold=0.0)
                        kwargs.pop("pass1_bits", None)
                    if not e.prefill_v_mask:
                        kwargs["v_keep"] = 0
                    attn_out, stats = prefill_attention(
                        qh, layer_cache.k, layer_cache.v, cos, sin,
                        lengths_l + s, pos_l, sm_scale=sm_scale, **kwargs)
                else:
                    attn_out, stats = spatten_attention_reference(
                        qh, layer_cache.k, layer_cache.v, cos, sin,
                        lengths_l + s, pos_l, sm_scale=sm_scale, **kwargs)
                if track_importance:
                    imp = state.importance[l]
                    if p.cascade_accumulate:
                        # reset the incoming tokens' slots, then accumulate
                        slot = torch.arange(cap, device=x.device)[
                            None, None, :]
                        is_new = ((slot >= lengths_l[:, None, None])
                                  & (slot < (lengths_l + s)[:, None, None]))
                        prev = torch.where(is_new, 0.0,
                                           imp.to(torch.float32))
                        imp.copy_((p.importance_ema * prev
                                   + stats.importance_delta).to(imp.dtype))
                    else:
                        imp.copy_(stats.importance_delta.to(imp.dtype))
            if m.latent:
                x = x + mla_out(attn_out, lp)
        if m.latent:
            x = mlp_block(x, l, lp)
        else:
            x = out_mlp(x, lp, attn_out, None if kept is None else kept[0])
        requants.append(stats.need_requant.sum())
        max_probs.append(stats.max_prob)
    return (x, state.layer_lengths + s,
            torch.stack(requants).to(torch.int32), torch.stack(max_probs))


def forward(params: Params, cfg: SpAttenConfig, state: DecodeState,
            tokens: torch.Tensor,
            rope_tables: tuple[torch.Tensor, torch.Tensor] | None = None,
            head_compact: dict | None = None, layer_offset: int = 0,
            tp_group=None) -> tuple[torch.Tensor, DecodeState, StepAux]:
    """Run S tokens [B, S] through the model, appending them to the cache.

    Returns (logits [B, S, vocab] f32, new_state, aux).  The input state's
    cache planes and importance are updated in place (consumed); the
    returned state holds them with the new lengths.  ``head_compact``:
    ``compact_head_params`` output (decode with compacted projections).
    ``tp_group``: this rank's tensor-parallel group (``cfg`` and the
    parameters then describe the rank's heads; see ``run_layers``)."""
    s = tokens.shape[1]
    with tracer.span("model.forward"):
        x, _ = embed_tokens(params, cfg, state, tokens)
        hits = [] if cfg.model.latent and tracer.on else None
        x, new_lengths, requants, max_probs = run_layers(
            head_compact["layers"] if head_compact else params["layers"],
            cfg, state, x, rope_tables=rope_tables,
            head_kept=(None if head_compact is None else
                       (head_compact["kept_q"], head_compact["kept_kv"])),
            layer_offset=layer_offset, tp_group=tp_group,
            expert_hits=hits)
        logits = lm_head(params, cfg, x)
        total = requants.sum().to(torch.int32)
        new_state = state._replace(
            lengths=state.lengths + s, layer_lengths=new_lengths,
            requant_events=state.requant_events + total)
    return logits, new_state, StepAux(
        requant_events=total, max_probs=max_probs, layer_requants=requants,
        expert_counts=torch.stack(hits) if hits else None)
