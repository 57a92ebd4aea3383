"""Decode-throughput benchmark of the port: the SpAtten engine against its
dense-int8 baseline (port of the JAX repository's root ``bench.py``).

    python -m spatten_tpu_torch.tools.bench

runs on the card and prints ONE JSON line:

    {"metric": "decode_tokens_per_s_per_chip", "value": N,
     "unit": "tok/s/chip", "vs_baseline": R, "detail": {...}}

The model is the per-chip TP-8 shard of Llama-2-7B (hidden 4096, 4 of 32
heads, 1/8 of the MLP, a 4000-token vocabulary), measured at
``BENCH_LAYERS`` = 8 layers; ``value`` and every point's ``*_tok_s`` are
the measured tokens/s scaled by 8/32 to the full 32-layer depth (an
extrapolation: per-layer cost taken as depth-independent), beside the
measured 8-layer figures (``*_tok_s_measured``).  ``SPATTEN_BENCH_MODEL=
gpt2-small`` benchmarks GPT-2 small (12 layers, 12 heads of 64, vocab
8192) unscaled instead.

The points (``SPATTEN_BENCH_POINTS``, default ``16384x32,8192x32,4096x16``:
capacity x batch) each time the SpAtten engine (``build_cfg(True, ...)``:
two-plane quantized KV, progressive requant at a calibrated threshold,
cascade token pruning, local V pruning, head pruning, K1 on every layer)
and the dense baseline (``build_cfg(False, ...)``: the same kernel with
every SpAtten stage off) over a warmed cache (``warm_state``,
``warm_cache_content``), and price a cascade prune (``measure_prune``:
K2).  The first point also reports the speedup at cache contrasts 1 and 5
and the prefill TTFT at prompts of 2048 and 8192 (``measure_prefill``),
unless ``SPATTEN_BENCH_NO_EXTRAS`` is set.  Other variables keep the JAX
bench's names and defaults: ``SPATTEN_BENCH_STEPS`` (128 decode steps a
window), ``SPATTEN_BENCH_REQUANT_Q`` (the calibration quantile, 0.15),
``SPATTEN_BENCH_LAYER_BITS`` (per-layer pass-1 bits).

Both engines run ``transformer.init_params`` from seed 0 with int8
weights (``weight_quant.quantize_params``).  A decode window is eager:
the prune check and the head-mask clock at its start, then ``steps``
``forward`` calls, as ``engine.generate``'s decode loop runs; each window
is timed on the host clock (``min`` over ``repeats``) and on the card by
CUDA events around it (``device_ms_per_step``: the stream's span from the
window's first launch to its last op, which includes the card's idle
gaps between launches, so it follows the host when launches bound the
step).  Every function takes ``device`` (default CUDA, raising without
it; the tests pass the CPU, where the kernel wrappers run their plain
versions).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from spatten_tpu_torch.config import (
    EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
)
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer, weight_quant
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.pruning import token_pruning

_SCALE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def bench_model() -> str:
    """``SPATTEN_BENCH_MODEL``, read at each call (JAX reads it once)."""
    return os.environ.get("SPATTEN_BENCH_MODEL", "llama2-7b-tp8")


def bench_layers() -> tuple[int, int]:
    """(layers measured, layers the reported tokens/s are scaled to)."""
    return (12, 12) if bench_model() == "gpt2-small" else (8, 32)


def shard_model_cfg() -> ModelConfig:
    if bench_model() == "gpt2-small":
        return dataclasses.replace(ModelConfig.gpt2_small(), vocab_size=8192,
                                   max_position_embeddings=2048)
    return ModelConfig(
        vocab_size=4000,         # 32000 / TP8
        hidden_size=4096,
        num_layers=bench_layers()[0],
        num_heads=4,             # 32 / TP8
        num_kv_heads=4,
        head_dim=128,
        intermediate_size=1376,  # 11008 / TP8
        tie_word_embeddings=True,
    )


def build_cfg(spatten: bool, cache: int, batch: int) -> SpAttenConfig:
    """The SpAtten engine's configuration at one point, or the dense-int8
    baseline's (every SpAtten stage off, the same kernel)."""
    if spatten:
        if bench_model() == "gpt2-small":
            ratios = (1.0, 0.93, 0.72, 0.52, 0.39, 0.31,
                      0.25, 0.21, 0.18, 0.16, 0.14, 0.14)
            head_keep = 10
        else:
            ratios = (1.0, 0.78, 0.25, 0.25, 0.25, 0.14, 0.14, 0.14)
            head_keep = 3
        pruning = PruningConfig(
            start_size=4,
            important_size=int(cache * 0.55),
            recent_size=int(cache * 0.10),
            cascade_layer_ratios=ratios,
            enable_v_pruning=True, v_keep_ratio=0.25,
            v_block_size=max(64, cache // 64),
            enable_head_pruning=True, head_keep=head_keep,
            head_update_interval=32,
            importance_dtype="bfloat16",
        )
        lb = os.environ.get("SPATTEN_BENCH_LAYER_BITS")
        layer_bits = tuple(int(x) for x in lb.split(",")) if lb else None
        quant = QuantConfig(enabled=True, enable_requant=True,
                            requant_threshold=0.05, quantize_queries=True,
                            layer_bits=layer_bits, pv_int8=True,
                            probs_bf16=True, scale_dtype="bfloat16")
    else:
        pruning = PruningConfig(enable_token_pruning=False,
                                enable_v_pruning=False)
        quant = QuantConfig(enabled=False, enable_requant=False,
                            quantize_queries=True, pv_int8=True,
                            probs_bf16=True, scale_dtype="bfloat16")
    return SpAttenConfig(
        model=shard_model_cfg(), pruning=pruning, quant=quant,
        engine=EngineConfig(max_batch_size=batch, cache_capacity=cache,
                            prefill_chunk=128, use_pallas=True,
                            rope_mode="cached"),
    ).validate()


def warm_state(cfg: SpAttenConfig, state):
    """Steady-state lengths: the pruned engine holds its per-layer cascade
    budgets (deeper layers fewer tokens); the dense engine holds the full
    context, less the room its timed windows need (read from
    ``SPATTEN_BENCH_STEPS``, as the JAX bench reads it, not from the
    window's ``steps``)."""
    b = state.lengths.shape[0]
    n_layers = cfg.model.num_layers
    dev = state.device
    if cfg.pruning.enable_token_pruning:
        p = cfg.pruning
        per_layer = [p.start_size + bl + p.recent_size for bl in
                     token_pruning.layer_budgets_static(p, n_layers)]
        layer_lengths = torch.tensor(per_layer, dtype=torch.int32,
                                     device=dev)[:, None].expand(
                                         n_layers, b).contiguous()
        warm = max(per_layer)
    else:
        steps = int(os.environ.get("SPATTEN_BENCH_STEPS", 128))
        budget = (1 + 3) * steps + 8
        cap = cfg.engine.cache_capacity
        warm = min(int(cap * 0.9), cap - budget)
        layer_lengths = torch.full((n_layers, b), warm, dtype=torch.int32,
                                   device=dev)
    return state._replace(
        lengths=torch.full((b,), warm, dtype=torch.int32, device=dev),
        layer_lengths=layer_lengths)


def _hash_rows(b: int, layer: int, cap: int, f: int, dev) -> torch.Tensor:
    """Batch row ``b``'s int8 rows [cap, f] of layer ``layer``: the JAX
    fill's int32 hash (wrapping products, an arithmetic shift, a floor
    modulus), computed in int64 and wrapped to int32 explicitly."""
    t = torch.arange(cap, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(f, dtype=torch.int64, device=dev)[None, :]
    # |sum * multiplier| < 2^63: no int64 overflow before the wrap
    x = ((b * 104729 + t * 7919 + c * 131 + layer * 17) * -1640531527
         ) & 0xFFFFFFFF
    h = torch.where(x >= 1 << 31, x - (1 << 32), x)      # int32 value
    return (torch.remainder(h >> 13, 255) - 127).to(torch.int8)


def warm_cache_content(cfg: SpAttenConfig, state, contrast: float = 19.0):
    """Fill the KV planes with synthetic content whose attention
    concentrates on the sink + recent-window tokens (the JAX bench's
    fill, byte for byte).

    K and V rows get the same hashed int8 content (and K its packed
    nibbles when quantization is on); the concentration is carried by the
    per-token K scales: sinks (below max(len // 20, 4)) and the recent
    fifth of each layer's length at 0.57, the middle at 0.57 / contrast
    (contrast 1 is the uniform worst case); V scales are 1/127.  As in
    JAX the 2-bit plane is dropped (the K planes become (full, msb,
    scale)), so a 6-bit layer reads its pass 1 at 4 bits, and the
    importance accumulator keeps its bytes.  Fills layer by layer and row
    by row; consumes ``state``."""
    m, e = cfg.model, cfg.engine
    n_layers, bsz, cap = m.num_layers, e.max_batch_size, e.cache_capacity
    f = m.num_kv_heads * m.head_dim
    dev = state.device
    k, v = state.cache.k, state.cache.v
    for layer in range(n_layers):
        for bi in range(bsz):
            q8 = _hash_rows(bi, layer, cap, f, dev)
            k.full[layer, bi].copy_(q8)
            v.full[layer, bi].copy_(q8)
            if cfg.quant.enabled:
                k.msb[layer, bi].copy_(qz.pack_msb(q8))
    sdt = _SCALE_DTYPES[cfg.quant.scale_dtype]
    t = torch.arange(cap, device=dev)[None, None, None, :]
    ln = state.layer_lengths.to(torch.int64)[:, :, None, None]  # [L, B, 1, 1]
    sink = t < torch.clamp(ln // 20, min=4)
    recent = (t >= (ln * 4) // 5) & (t < ln)
    kscale = torch.where(sink | recent, torch.tensor(0.57, device=dev),
                         torch.tensor(0.57 / contrast, device=dev)).to(sdt)
    k.scale.copy_(kscale.expand(n_layers, bsz, m.num_kv_heads, cap))
    v.scale.fill_(1.0 / 127)
    cache = state.cache._replace(
        k=qz.QuantizedKV(full=k.full, msb=k.msb if cfg.quant.enabled
                         else None, scale=k.scale),
        v=qz.QuantizedKV(full=v.full, msb=None, scale=v.scale))
    return state._replace(cache=cache)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_decode(cfg: SpAttenConfig, params, steps: int, repeats: int = 3,
                contrast: float = 19.0, *, device="cuda",
                timing: dict | None = None):
    """Returns (tokens/sec, final_state); ``final_state.requant_events``
    accumulates over exactly ``steps * (1 + repeats)`` executed steps.

    One untimed window, then ``repeats`` timed windows of ``steps`` greedy
    decode steps from a warmed cache; tokens/s from the fastest on the
    host clock.  Each window starts with the prune check (none may fire:
    asserted from the host schedule) and the head-mask clock over the
    window (``maybe_update_head_mask(window=steps)``), as the JAX window
    does.  ``timing``, when given, receives ``host_ms_per_step`` (the
    fastest window), ``device_ms_per_step`` (CUDA events around that
    window; the host clock on the CPU) and ``first_window_s``."""
    dev = resolve_device(device)
    b = cfg.engine.max_batch_size
    state = init_state(cfg, batch=b, device=dev)
    state = warm_state(cfg, state)
    state = warm_cache_content(cfg, state, contrast=contrast)
    token = torch.zeros((b,), dtype=torch.int32, device=dev)

    host_lens = [int(x) for x in state.layer_lengths[:, 0].tolist()]
    for w in range(repeats + 1):
        layers, host_lens = gen.prune_schedule_step(cfg, host_lens, steps)
        assert not layers, (
            f"bench window {w} would trigger a prune of layers {layers};"
            " increase layer_cap_headroom or reduce steps")
    tables = rope_ops.rope_table(cfg.engine.cache_capacity,
                                 cfg.model.head_dim, cfg.model.rope_theta,
                                 dev)

    def window(state, token, n):
        state, _ = gen.maybe_prune(cfg, state, n, static_layers=())
        state = gen.maybe_update_head_mask(cfg, state, window=n)
        for _ in range(n):
            logits, state, _ = transformer.forward(
                params, cfg, state, token[:, None], rope_tables=tables)
            token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return state, token

    t0 = time.perf_counter()
    state, token = window(state, token, steps)
    token.cpu()
    first = time.perf_counter() - t0
    log(f"first window: {first:.1f}s")

    best, best_dev = float("inf"), float("inf")
    for _ in range(repeats):
        if dev.type == "cuda":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            _sync(dev)
        t0 = time.perf_counter()
        if dev.type == "cuda":
            ev[0].record()
        state, token = window(state, token, steps)
        if dev.type == "cuda":
            ev[1].record()
        token.cpu()
        host = time.perf_counter() - t0
        if host < best:
            best = host
            best_dev = (ev[0].elapsed_time(ev[1]) / 1e3 if dev.type == "cuda"
                        else host)
    log(f"timed: {best:.3f}s ({best / steps * 1e3:.2f} ms/step; device "
        f"{best_dev / steps * 1e3:.2f})")
    if timing is not None:
        timing.update(host_ms_per_step=best / steps * 1e3,
                      device_ms_per_step=best_dev / steps * 1e3,
                      first_window_s=first)
    return b * steps / best, state


def prune_runs(cfg: SpAttenConfig, reps: int = 8) -> list:
    """(layers, n) of each run ``measure_prune`` makes: every layer at
    once, layer 0 alone, then one layer at each other rung."""
    n_layers = cfg.model.num_layers
    caps_l = token_pruning.layer_capacities(cfg)
    runs = [(tuple(range(n_layers)), reps), ((0,), reps)]
    seen = {caps_l[0]}
    for l in range(1, n_layers):
        if caps_l[l] not in seen:
            seen.add(caps_l[l])
            runs.append(((l,), max(4, reps // 2)))
    return runs


def measure_prune(cfg: SpAttenConfig, params, reps: int = 8, *,
                  device="cuda"):
    """(worst_ms, steady_ms, amortized_ms) for cascade-prune events.

    worst: every layer triggers at once; steady: layer 0 alone (the
    largest window); amortized: the sum over layers of one measured event
    at the layer's rung over (rung - keep bound), the per-step cost of
    the staggered schedule.  Each run (``prune_runs``) refills the
    selected layers to their rung and prunes them with the schedule's
    ``static_layers``, ``n`` times untimed and ``n`` times timed."""
    dev = resolve_device(device)
    if not cfg.pruning.enable_token_pruning:
        return 0.0, 0.0, 0.0
    b = cfg.engine.max_batch_size
    n_layers = cfg.model.num_layers
    caps_l = token_pruning.layer_capacities(cfg)
    caps = torch.tensor(caps_l, dtype=torch.int32, device=dev)[:, None]

    def run(layers, n):
        sel = torch.zeros((n_layers, 1), dtype=torch.bool, device=dev)
        sel[list(layers)] = True
        state = warm_cache_content(
            cfg, warm_state(cfg, init_state(cfg, batch=b, device=dev)))

        def prune_window(state, n):
            for _ in range(n):
                ll = torch.where(sel, caps.expand(n_layers, b),
                                 state.layer_lengths)
                state = state._replace(layer_lengths=ll,
                                       lengths=ll.amax(dim=0))
                state, _ = gen.maybe_prune(cfg, state, 1,
                                           static_layers=layers)
            return state

        state = prune_window(state, n)
        state.lengths.cpu()
        t0 = time.perf_counter()
        state = prune_window(state, n)
        state.lengths.cpu()
        return (time.perf_counter() - t0) / n * 1e3

    runs = prune_runs(cfg, reps)
    times = [run(layers, n) for layers, n in runs]
    event_by_rung = {caps_l[layers[0]]: t
                     for (layers, _), t in zip(runs[1:], times[1:])}
    return times[0], times[1], amortized_ms(cfg, event_by_rung)


def amortized_ms(cfg: SpAttenConfig, event_by_rung: dict) -> float:
    """Per-step prune cost: each layer's event time at its rung over the
    steps between its prunes (rung - keep bound)."""
    caps_l = token_pruning.layer_capacities(cfg)
    keeps_l = token_pruning.layer_keep_max_static(cfg.pruning,
                                                  cfg.model.num_layers)
    return sum(event_by_rung[c] / max(c - k, 1)
               for c, k in zip(caps_l, keeps_l))


def measure_prefill(cfg: SpAttenConfig, params, prompt_len: int,
                    reps: int = 2, *, device="cuda"):
    """(prefill tokens/s, TTFT ms): chunked prefill of a ``prompt_len``
    prompt of ones for the full batch, as ``generate`` runs it; TTFT is
    the host time from the first chunk to the last token's logits on the
    host, the fastest of ``reps`` runs after one untimed run."""
    dev = resolve_device(device)
    b = cfg.engine.max_batch_size
    tokens = torch.ones((b, prompt_len), dtype=torch.int64, device=dev)

    def run():
        state = init_state(cfg, batch=b, device=dev)
        logits, state, _, _ = gen.prefill(params, cfg, state, tokens)
        logits[:, :1].cpu()

    t0 = time.perf_counter()
    run()
    log(f"prefill {prompt_len}: first {time.perf_counter() - t0:.1f}s")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return b * prompt_len / best, best * 1e3


def calibrate_requant(cfg: SpAttenConfig, params, quantile: float = 0.15, *,
                      device="cuda") -> float:
    """The requant threshold at which ``quantile`` of the (layer, row, kv
    head) max probabilities of one decode step over the warmed cache lie
    below it (a ~15% firing rate by default)."""
    dev = resolve_device(device)
    b = cfg.engine.max_batch_size
    state = init_state(cfg, batch=b, device=dev)
    state = warm_state(cfg, state)
    state = warm_cache_content(cfg, state)
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    _, _, aux = transformer.forward(params, cfg, state, token[:, None])
    maxp = aux.max_probs.to(torch.float32).cpu().numpy()
    return float(np.quantile(maxp, quantile))


def run_point(cache: int, batch: int, steps: int, params,
              primary: bool = False, *, device="cuda",
              repeats: int = 3) -> dict:
    """Measure one (cache, batch) serving point.  Returns a dict with the
    JAX bench's keys, plus the measured (unscaled) tokens/s and the host
    and device ms per step of each engine."""
    dev = resolve_device(device)
    cfg_sp = build_cfg(True, cache, batch)
    cfg_dn = build_cfg(False, cache, batch)

    rq = float(os.environ.get("SPATTEN_BENCH_REQUANT_Q", 0.15))
    thr = calibrate_requant(cfg_sp, params, quantile=rq, device=dev)
    log(f"[cap {cache} b {batch}] calibrated requant threshold: {thr:.3e}"
        f" (quantile {rq})")
    cfg_sp = dataclasses.replace(
        cfg_sp, quant=dataclasses.replace(cfg_sp.quant,
                                          requant_threshold=thr))

    log(f"[cap {cache} b {batch}] timing spatten engine...")
    t_sp = {}
    tps_sp, end_state = time_decode(cfg_sp, params, steps, repeats=repeats,
                                    device=dev, timing=t_sp)
    total_steps = steps * (1 + repeats)
    m = cfg_sp.model
    denom = total_steps * m.num_layers * batch * m.num_kv_heads
    requant_rate = float(end_state.requant_events.cpu()) / denom
    hm = end_state.head_mask.to(torch.float32).cpu()
    head_keep = float(hm.mean())
    head_keep_per_layer = [round(float(x), 3) for x in hm.mean(dim=1)]
    del end_state
    log(f"[cap {cache} b {batch}] spatten: {tps_sp:.1f} tok/s; dense...")
    t_dn = {}
    tps_dn, dn_state = time_decode(cfg_dn, params, steps, repeats=repeats,
                                   device=dev, timing=t_dn)
    del dn_state
    log(f"[cap {cache} b {batch}] dense: {tps_dn:.1f} tok/s")

    try:
        prune_ms, prune_steady_ms, prune_amort_ms = measure_prune(
            cfg_sp, params, device=dev)
    except Exception as e:                       # pragma: no cover
        log(f"measure_prune failed: {e!r}")
        prune_ms = prune_steady_ms = prune_amort_ms = -1.0

    measured, full = bench_layers()
    scale = measured / full
    point = {
        "cache_capacity": cache, "batch": batch,
        "spatten_tok_s": round(tps_sp * scale, 2),
        "dense_int8_tok_s": round(tps_dn * scale, 2),
        "vs_baseline": round(tps_sp / tps_dn, 3),
        "prune_ms_per_event": round(prune_ms, 3),
        "prune_ms_steady_event": round(prune_steady_ms, 3),
        "prune_ms_amortized": round(prune_amort_ms, 5),
        "requant_threshold": thr,
        "requant_rate": round(requant_rate, 4),
        "head_keep_fraction": round(head_keep, 3),
        "head_keep_per_layer": head_keep_per_layer,
        "spatten_tok_s_measured": tps_sp,
        "dense_int8_tok_s_measured": tps_dn,
        "layers_measured": measured,
        "spatten_host_ms_per_step": t_sp["host_ms_per_step"],
        "spatten_device_ms_per_step": t_sp["device_ms_per_step"],
        "dense_host_ms_per_step": t_dn["host_ms_per_step"],
        "dense_device_ms_per_step": t_dn["device_ms_per_step"],
    }
    if primary and not os.environ.get("SPATTEN_BENCH_NO_EXTRAS"):
        sens = {"contrast_19x": round(tps_sp / tps_dn, 3)}
        for contrast in (1.0, 5.0):
            t_c, st = time_decode(cfg_sp, params, steps, repeats=repeats,
                                  contrast=contrast, device=dev)
            del st
            sens[f"contrast_{contrast:g}x"] = round(t_c / tps_dn, 3)
            log(f"[sens] contrast {contrast:g}x: vs_baseline "
                f"{t_c / tps_dn:.3f}")
        point["vs_baseline_by_contrast"] = sens
        prefill = {}
        for plen in (2048, 8192):
            if plen > cache:
                continue
            try:
                sp_tps, sp_ttft = measure_prefill(cfg_sp, params, plen,
                                                  device=dev)
                dn_tps, dn_ttft = measure_prefill(cfg_dn, params, plen,
                                                  device=dev)
            except Exception as e:               # pragma: no cover
                log(f"measure_prefill({plen}) failed: {e!r}")
                continue
            prefill[str(plen)] = {
                "spatten_tok_s": round(sp_tps * scale, 1),
                "dense_tok_s": round(dn_tps * scale, 1),
                "spatten_ttft_ms": round(sp_ttft / scale, 1),
                "dense_ttft_ms": round(dn_ttft / scale, 1),
                "spatten_ttft_ms_measured": sp_ttft,
                "dense_ttft_ms_measured": dn_ttft,
            }
            log(f"[prefill {plen}] spatten {sp_tps:.0f} tok/s "
                f"(TTFT {sp_ttft:.0f} ms), dense {dn_tps:.0f} tok/s "
                f"(TTFT {dn_ttft:.0f} ms)")
        point["prefill"] = prefill
    return point


def card(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them (the
    CPU: "cpu")."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def bench_params(dev, generator: int = 0):
    """The bench's weights: ``init_params`` from ``generator`` (a seed),
    every matmul weight then int8 (both engines)."""
    return weight_quant.quantize_params(transformer.init_params(
        shard_model_cfg(), generator, device=dev))


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    steps = int(os.environ.get("SPATTEN_BENCH_STEPS", 128))
    gpt2 = bench_model() == "gpt2-small"
    points = os.environ.get("SPATTEN_BENCH_POINTS",
                            "2048x64,1024x64" if gpt2
                            else "16384x32,8192x32,4096x16")
    params = bench_params(dev)

    results = []
    for i, spec in enumerate(points.split(",")):
        cache, batch = (int(x) for x in spec.split("x"))
        results.append(run_point(cache, batch, steps, params,
                                 primary=(i == 0), device=dev))

    measured, full = bench_layers()
    primary = results[0]
    out = {
        "metric": "decode_tokens_per_s_per_chip",
        "value": primary["spatten_tok_s"],
        "unit": "tok/s/chip",
        "vs_baseline": primary["vs_baseline"],
        "detail": {
            "model": ("gpt2-small (12L, d=64 heads, full model)" if gpt2
                      else "llama2-7b TP8 per-chip shard "
                      f"({measured}L measured, scaled to {full}L)"),
            "device": card(dev),
            "steps": steps,
            "points": results,
        },
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
