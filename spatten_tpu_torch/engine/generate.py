"""Generation engine: prefill, decode and capacity-triggered cascade
pruning (port of ``spatten_tpu/engine/generate.py``).

The same window and prune-point semantics as the JAX engine, so the two
produce the same greedy token stream:

* generation appends one token to every layer of every sequence per
  step, so the per-layer prune schedule is a pure function of the step
  count (``prune_schedule_step``) and ``maybe_prune`` runs with the
  host-known ``static_layers``;
* prompts run in chunks of ``prefill_chunk``, with a prune before any
  chunk that would overflow a layer's capacity rung;
* decode runs in windows of ``decode_window`` steps (clamped to the
  pruning headroom) with a prune, when scheduled, before each window;
* under ``SPATTEN_DEBUG=1`` a prompt's first chunk runs under
  ``utils.debug.checkify_step``;
* head pruning derives the per-layer head mask from the importance
  accumulators once after prefill and, on the fly, at every window
  boundary where the length clock crosses ``head_update_interval``
  (``window_start``; ``decode_step`` checks every step through
  ``maybe_update_head_mask``); with ``head_update_interval == 0`` and
  ``compact_pruned_heads`` the attention projections are compacted once
  to the kept heads.

The window body is a plain Python loop over ``forward``.  Functions that
take a state update its tensors in place and consume it.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple, Optional

import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine import prefill_graph
from spatten_tpu_torch.engine.policy import update_head_mask
from spatten_tpu_torch.engine.sampling import SamplingParams, sample_token
from spatten_tpu_torch.engine.state import DecodeState, init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.pruning import compact, token_pruning
from spatten_tpu_torch.utils import debug as dbg
from spatten_tpu_torch.utils.profiling import tracer


def maybe_prune(cfg: SpAttenConfig, state: DecodeState, num_coming: int,
                static_layers: Optional[tuple[int, ...]] = None,
                ) -> tuple[DecodeState, torch.Tensor]:
    """Compact any (layer, sequence) whose next ``num_coming`` tokens would
    overflow the layer's capacity rung.  Consumes ``state`` (the cache
    and importance are compacted in place).

    Returns (state, pruned_mask [B]).  ``static_layers``: the layers the
    host-side schedule says trigger (others are untouched; per-sequence
    identity keeps still apply); ``()`` is a no-op; None checks every
    layer's trigger on the host.
    """
    with tracer.span("engine.prune") as span:
        p = cfg.pruning
        num_layers = cfg.model.num_layers
        dev = state.device
        caps = token_pruning.layer_capacities(cfg)
        with tracer.sync("prune.caps"):
            caps_t = torch.tensor(caps, device=dev)
        trigger_layer = state.layer_lengths + num_coming > caps_t[:, None]
        if static_layers is not None:
            with tracer.sync("prune.listed"):
                listed = torch.tensor(
                    [l in static_layers for l in range(num_layers)],
                    device=dev)
            trigger_layer = trigger_layer & listed[:, None]
        trigger = trigger_layer.any(dim=0)
        if not p.enable_token_pruning or static_layers == ():
            return state, torch.zeros_like(trigger)
        if static_layers is None:
            # one read, and one more for each layer it finds triggered
            with tracer.sync("prune.layers"):
                static_layers = tuple(
                    int(l) for l in
                    torch.nonzero(trigger_layer.any(dim=1))[:, 0])
        if static_layers:
            span.note(layers=len(static_layers))

        with tracer.sync("prune.budgets"):
            budgets = token_pruning.layer_budgets(p, num_layers, dev)
        budgets_static = token_pruning.layer_budgets_static(p, num_layers)
        cached_rope = (cfg.engine.rope_mode == "cached"
                       and not cfg.model.use_abs_pos_emb)
        # keep_count is pure arithmetic (the selection's own count formula)
        recent_begin = state.layer_lengths - p.recent_size        # [L, B]
        n_imp = torch.minimum(budgets[:, None],
                              torch.clamp(recent_begin - p.start_size, min=0))
        keep_count = (p.start_size + n_imp + p.recent_size).to(torch.int32)

        m = cfg.model
        rope = None
        for l in static_layers:
            trig_l = trigger_layer[l]
            keep_max_l = p.start_size + budgets_static[l] + p.recent_size
            window = caps[l]
            imp_l = state.importance[l][None, :, :, :window]
            if m.importance_heads != m.cache_heads:
                # a latent row's importance: summed over the query heads
                imp_l = imp_l.to(torch.float32).sum(dim=2, keepdim=True)
            kidx, _ = token_pruning.select_keep_indices_budgeted(
                imp_l,
                state.layer_lengths[l][None], p.start_size, budgets[l:l + 1],
                budgets_static[l], p.recent_size, num_coming=0)
            ident = torch.arange(keep_max_l, dtype=torch.int32,
                                 device=dev).expand_as(kidx[0])
            kidx = torch.where(trig_l[:, None, None], kidx[0], ident)
            kc = torch.where(trig_l, keep_count[l],
                             torch.full_like(keep_count[l], keep_max_l))
            if rope is None and cached_rope:
                rope = rope_ops.rope_lanes(m, dev)
            compact.compact_layer(
                state.cache.layer(l), state.importance[l], kidx,
                rotate_k=cached_rope, rope=rope,
                lengths=state.layer_lengths[l], triggered=trig_l,
                keep_count=kc, window=window,
                use_gather_kernel=None if cfg.engine.use_pallas else False)
        layer_lengths = torch.where(trigger_layer, keep_count,
                                    state.layer_lengths)
        return state._replace(layer_lengths=layer_lengths,
                              lengths=layer_lengths.amax(dim=0)), trigger


def prune_schedule_step(cfg: SpAttenConfig, host_lens: list, num_coming: int
                        ) -> tuple[tuple[int, ...], list]:
    """Host-side replica of the per-layer trigger/keep bookkeeping.

    Returns (layers triggering now, layer lengths AFTER the prune and the
    ``num_coming`` appends)."""
    p = cfg.pruning
    if not p.enable_token_pruning:
        return (), [x + num_coming for x in host_lens]
    caps = token_pruning.layer_capacities(cfg)
    budg = token_pruning.layer_budgets_static(p, cfg.model.num_layers)
    layers = []
    out = list(host_lens)
    for l, ln in enumerate(out):
        if ln + num_coming > caps[l]:
            rb = ln - p.recent_size
            out[l] = (p.start_size + min(budg[l], max(rb - p.start_size, 0))
                      + p.recent_size)
            layers.append(l)
    return tuple(layers), [x + num_coming for x in out]


def prefill_chunk(params, cfg: SpAttenConfig, state: DecodeState,
                  tokens: torch.Tensor, *, static_layers=None,
                  graph: Optional[prefill_graph.PrefillGraph] = None):
    """Run one chunk of prompt tokens [B, S], pruning first when needed.
    Consumes ``state``.  Returns (last-token logits [B, V], state, aux).

    ``graph``: a ``prefill_graph.PrefillGraph`` over ``params`` and
    ``cfg``; where ``prefill_graph.engages`` (a batch-1, full-length
    chunk on the card), the forward replays from it after the prune."""
    with tracer.span("engine.prefill", rows=tokens.size(0),
                     tokens=tokens.size(1)):
        state, _ = maybe_prune(cfg, state, tokens.shape[1],
                               static_layers=static_layers)
        if graph is not None and prefill_graph.engages(
                cfg, tokens.device.type, tokens.shape):
            return graph.run(state, tokens)
        logits, state, aux = transformer.forward(params, cfg, state, tokens)
        return logits[:, -1], state, aux


def prefill_scan(params, cfg: SpAttenConfig, state: DecodeState,
                 tokens: torch.Tensor, *, nchunks: int):
    """``nchunks`` equal prompt chunks of ``tokens`` [B, nchunks * chunk]
    in a row, with no prune between them (JAX's one-dispatch scan over a
    segment; the caller segments at the schedule's prune points).
    Raises ValueError, before running any, where the schedule would prune
    at a chunk.  Consumes ``state``.  Returns (last-token logits, state)."""
    b, total = tokens.shape
    if total % nchunks:
        raise ValueError(f"{total} tokens do not split into {nchunks} "
                         f"chunks")
    chunk = total // nchunks
    lens = state.layer_lengths.amax(dim=1).tolist()
    for i in range(nchunks):
        layers, lens = prune_schedule_step(cfg, lens, chunk)
        if layers:
            raise ValueError(f"layers {layers} prune at chunk {i} of the "
                             f"scan; segment the prompt there")
    last = None
    for i in range(nchunks):
        logits, state, _ = transformer.forward(
            params, cfg, state, tokens[:, i * chunk:(i + 1) * chunk])
        last = logits[:, -1]
    return last, state


def _prefill_step(params, cfg: SpAttenConfig, state: DecodeState,
                  tokens: torch.Tensor, layers, first: bool):
    """``prefill_chunk``; under ``SPATTEN_DEBUG=1`` a prompt's first chunk
    runs under ``utils.debug.checkify_step``, so numeric corruption (a
    NaN escaping a masked region, a zero softmax denominator) raises at
    the producing op instead of surfacing as garbage tokens."""
    step = functools.partial(prefill_chunk, params, cfg,
                             static_layers=layers)
    if first and dbg.enabled():
        return dbg.checkify_step(step, state, tokens)
    return step(state, tokens)


def prefill(params, cfg: SpAttenConfig, state: DecodeState,
            tokens: torch.Tensor, host_lens: Optional[list] = None):
    """Full prompt prefill with schedule-known prunes between chunks (the
    first chunk checked under ``SPATTEN_DEBUG=1``, ``_prefill_step``).
    Consumes ``state``.  Returns (last_logits, state, host_lens,
    pruned_layers): the layers pruned at each prune point, in order."""
    total = tokens.shape[1]
    chunk = cfg.engine.prefill_chunk
    if host_lens is None:
        host_lens = [0] * cfg.model.num_layers
    last_logits, pruned = None, []
    for pos in range(0, total, chunk):
        n = min(chunk, total - pos)
        layers, host_lens = prune_schedule_step(cfg, host_lens, n)
        if layers:
            pruned.append(layers)
        last_logits, state, _ = _prefill_step(
            params, cfg, state, tokens[:, pos:pos + n], layers,
            first=pos == 0)
    return last_logits, state, host_lens, pruned


def head_mask_due(cfg: SpAttenConfig, clock: int, window: int = 1) -> bool:
    """Whether the on-the-fly head mask update fires at a window of
    ``window`` steps starting at length clock ``clock`` (the maximum
    sequence length): when the clock crosses a multiple of
    ``head_update_interval`` within the window."""
    p = cfg.pruning
    n = p.head_update_interval
    if not (p.enable_head_pruning and p.head_keep > 0 and n > 0):
        return False
    return clock % n < window


def maybe_update_head_mask(cfg: SpAttenConfig, state: DecodeState,
                           window: int = 1) -> DecodeState:
    """On-the-fly head pruning: re-derive the per-layer head mask from the
    live importance accumulators when ``head_mask_due`` at the clock
    ``max(state.lengths)``: before one decode step (``window`` 1), or
    before a window of ``window`` steps, where it fires when the clock
    crosses a multiple of ``head_update_interval`` within the window."""
    with tracer.sync("head_mask.clock"):
        clock = int(state.lengths.max())
    if head_mask_due(cfg, clock, window):
        with tracer.span("engine.head_mask"):
            state = update_head_mask(cfg, state)
    return state


def decode_step(params, cfg: SpAttenConfig, state: DecodeState,
                token: torch.Tensor):
    """One greedy decode step (pruning and the head mask update first,
    when due).  Consumes ``state``.  token: int32 [B] -> (next_token [B],
    state, aux)."""
    with tracer.span("engine.decode"):
        state, _ = maybe_prune(cfg, state, 1)
        state = maybe_update_head_mask(cfg, state)
        logits, state, aux = transformer.forward(params, cfg, state,
                                                 token[:, None])
        return (torch.argmax(logits[:, -1], dim=-1).to(torch.int32), state,
                aux)


class GenerateResult(NamedTuple):
    tokens: torch.Tensor            # int32 [B, max_new_tokens]
    state: DecodeState
    requant_events: torch.Tensor    # int32 []
    pruned_layers: list             # layers pruned at each prune point
    prefill_seconds: float          # host clock, device synchronised
    decode_seconds: float
    head_mask_updates: list         # length clock at each mask update
    layer_requants: torch.Tensor    # int32 [L] decode requants by layer


def decode_window_steps(cfg: SpAttenConfig) -> int:
    """Decode window length: ``decode_window`` clamped to the tightest
    per-layer slack between a capacity rung and its static keep bound."""
    steps = cfg.engine.decode_window
    if cfg.pruning.enable_token_pruning:
        caps = token_pruning.layer_capacities(cfg)
        keeps = token_pruning.layer_keep_max_static(cfg.pruning,
                                                    cfg.model.num_layers)
        steps = max(1, min(steps, min(c - k for c, k in zip(caps, keeps))))
    return steps


def window_start(cfg: SpAttenConfig, state: DecodeState, n: int,
                 host_lens: Optional[list] = None):
    """The work at a decode-window boundary of ``n`` steps: the prune (the
    schedule-known layers when ``host_lens`` is given, else checked on
    the host), then the head mask update when due.  Consumes ``state``.
    Returns (state, host_lens after the window, pruned layers or None,
    the length clock when the mask was updated or None)."""
    if host_lens is not None:
        layers, host_lens = prune_schedule_step(cfg, host_lens, n)
        if layers:
            state, _ = maybe_prune(cfg, state, n, static_layers=layers)
        clock = max(host_lens) - n       # max(state.lengths), on the host
    else:
        layers = None
        state, _ = maybe_prune(cfg, state, n)
        clock = int(state.lengths.max())
    updated = None
    if head_mask_due(cfg, clock, n):
        state = update_head_mask(cfg, state)
        updated = clock
    return state, host_lens, layers, updated


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def generate(
    params,
    cfg: SpAttenConfig,
    prompt,                          # int [B, prompt_len] (tensor or array)
    max_new_tokens: int,
    state: Optional[DecodeState] = None,
    eos_token_id: Optional[int] = None,
    sampling: Optional[SamplingParams] = None,
    generator: Optional[torch.Generator] = None,
    device: str | torch.device = "cuda",
) -> GenerateResult:
    """Chunked prefill, then token-at-a-time decode in windows.

    Runs on ``device`` (default CUDA; raises when CUDA is missing), where
    ``params`` must already live.  EOS freezes finished sequences (they
    keep emitting ``eos_token_id``).  Greedy by default; pass ``sampling``
    and a ``generator`` for temperature / top-k / top-p.
    """
    cfg.validate()
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params live on {params['embed'].device}, "
                         f"not on {dev}")
    sampling = sampling or SamplingParams()
    prompt = torch.as_tensor(prompt, dtype=torch.int64).to(dev)
    b = prompt.shape[0]
    if state is None:
        state = init_state(cfg, batch=b, device=dev)

    # host-side prune schedule: exact when every sequence of a layer has
    # the same length; otherwise the triggers are checked on the host
    ll_host = state.layer_lengths.cpu()
    static_ok = bool((ll_host == ll_host[:, :1]).all())
    host_lens = [int(x) for x in ll_host[:, 0]]
    pruned: list = []

    t0 = time.perf_counter()
    if static_ok:
        last_logits, state, host_lens, pruned = prefill(
            params, cfg, state, prompt, host_lens=host_lens)
    else:
        chunk = cfg.engine.prefill_chunk
        for pos in range(0, prompt.shape[1], chunk):
            last_logits, state, _ = _prefill_step(
                params, cfg, state, prompt[:, pos:pos + chunk], None,
                first=pos == 0)
    head_updates: list = []
    head_compact = None
    if cfg.pruning.enable_head_pruning and cfg.pruning.head_keep > 0:
        state = update_head_mask(cfg, state)
        head_updates.append(max(host_lens) if static_ok
                            else int(state.lengths.max()))
        if (cfg.pruning.head_update_interval == 0
                and cfg.engine.compact_pruned_heads):
            # permanent mode: the mask is fixed from here on
            head_compact = transformer.compact_head_params(
                params, cfg, state.head_mask)
    _sync(dev)
    t1 = time.perf_counter()

    token = sample_token(last_logits, generator, sampling)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    tables = rope_ops.model_rope_table(cfg.model, cfg.engine.cache_capacity,
                                       dev)
    window_steps = decode_window_steps(cfg)
    out = []
    layer_requants = torch.zeros((cfg.model.num_layers,), dtype=torch.int32,
                                 device=dev)
    remaining = max_new_tokens
    while remaining > 0:
        n = min(window_steps, remaining)
        state, host_lens, layers, updated = window_start(
            cfg, state, n, host_lens if static_ok else None)
        if layers:
            pruned.append(layers)
        if updated is not None:
            head_updates.append(updated)
        for _ in range(n):
            logits, state, aux = transformer.forward(
                params, cfg, state, token[:, None], rope_tables=tables,
                head_compact=head_compact)
            layer_requants += aux.layer_requants
            next_token = sample_token(logits[:, -1], generator, sampling)
            if eos_token_id is not None:
                done = done | (token == eos_token_id)
                next_token = torch.where(done, eos_token_id, next_token)
            out.append(token)
            token = next_token
        remaining -= n
    _sync(dev)
    t2 = time.perf_counter()
    return GenerateResult(tokens=torch.stack(out, dim=1), state=state,
                          requant_events=state.requant_events,
                          pruned_layers=pruned, prefill_seconds=t1 - t0,
                          decode_seconds=t2 - t1,
                          head_mask_updates=head_updates,
                          layer_requants=layer_requants)
