#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spatten_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without
one (or without the repository beside it).  Phases, none of whose
failures is caught:

1. the card's name and power limit; build both kernels from ``csrc/``
   (one ``nvcc`` per source, in parallel);
2. K1 (fused decode attention) vs its plain PyTorch version on the card,
   at the slice's shapes for one layer of the 32-layer stacked cache,
   ragged lengths, a requant threshold that splits the heads, V pruning;
3. K2 (prune compaction) vs its plain version: random sorted keep sets,
   one untriggered sequence;
4. a small-model reference check (kernels on the card vs plain versions
   on the CPU, f32 weights), then the main path: ``generate`` with random
   bf16 weights at Llama-2-7B width and depth (32 layers), batch 4,
   prompt 1152, 128 new tokens, counting kernel launches; then the first
   decode window again through the plain versions on the card, fed the
   same tokens, comparing logits;
5. a ``kernels`` JSON line: per kernel its launches, error, time on the
   card (``ms``), its plain version's (``plain_ms``), the least time the
   card could take (``bound_ms``, with ``bound_by``), and a PyTorch
   library call's time where one computes the same function;
6. as the last line, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12                   # H100 SXM f32 outside the tensor cores
# tolerances of the kernel-vs-plain checks (f32 sums in another order)
K1_OUT_TOL = dict(atol=1e-4, rtol=1e-4)
K1_MAXP_TOL = dict(atol=1e-6, rtol=1e-4)
K1_IMP_TOL = dict(atol=1e-5, rtol=1e-4)
DECISION_MARGIN = 1e-5              # closer decisions may flip either way
# Kernels vs plain versions on the card, teacher-forced (the same tokens
# fed to both).  A V-block keep decision whose k-th and (k+1)-th block
# masses nearly tie may resolve differently in the two (the kernel ranks
# unnormalized sums), and one such flip moves the logits of its step and
# of later layers; so the checks hold most steps, not every step.
# Small f32 model: a step agrees when its max |logit diff| <= 1e-3.
SMALL_STEP_TOL = 1e-3
SMALL_STEPS_MIN = 0.9
# Main path, bf16: logits are bf16 values (~N(0, 1) at random init; a bf16
# step is 2^-7 to 2^-5 there) and any last-bit difference in an attention
# output reaches the bf16 residual stream, so the window is held by its
# mean error (a few bf16 steps) and its argmax agreement.
WINDOW_MEAN_TOL = 0.05
WINDOW_ARGMAX_MIN = 0.8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def device_ms(fn, n: int) -> float:
    """Device time of one call of ``fn(i)``, averaged over n calls.

    The calls queue behind a ``torch.cuda._sleep`` so that the events
    bracket back-to-back device work, not the host's launch gaps."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2e8, 4e9 * host_s)))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def slice_config(num_layers: int = 32):
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=dataclasses.replace(ModelConfig.llama2_7b(),
                                  num_layers=num_layers),
        pruning=PruningConfig(start_size=4, important_size=384,
                              recent_size=384),
        quant=QuantConfig(),
        engine=EngineConfig(max_batch_size=4, cache_capacity=1024,
                            prefill_chunk=128),
    ).validate()


# ---------------------------------------------------------------- phase 2
def k1_inputs(cfg, dev, gen):
    """One layer's worth of realistic cache (quantized normals), copied to
    every layer of the stacked planes, plus the step's query and row."""
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.ops import quantize as qz
    m = cfg.model
    b, hq, hkv, d, cap = 4, m.num_heads, m.num_kv_heads, m.head_dim, \
        cfg.engine.cache_capacity
    st = init_state(cfg, batch=b, device=dev)
    k = qz.quantize(torch.randn((b, hkv, cap, d), generator=gen, device=dev))
    v = qz.quantize(torch.randn((b, hkv, cap, d), generator=gen, device=dev),
                    with_msb=False)
    for dst, src in ((st.cache.k, k), (st.cache.v, v)):
        for name in ("full", "msb", "scale"):
            if getattr(dst, name) is not None:
                getattr(dst, name).copy_(getattr(src, name)[None])
    st.importance.uniform_(generator=gen)
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev)
    k_new = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    v_new = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    lengths = torch.tensor([1024, 900, 513, 77], dtype=torch.int32,
                           device=dev)
    return st, q, k_new, v_new, lengths


def k1_bound(cfg, lengths, need, keep_any_tokens, quant=True):
    """(bound_ms, bound_by, bytes, flops) of one K1 call on these inputs:
    every input byte the function needs read once, every output written
    once (msb rows serving live tokens, the int8 rows of requant heads,
    the kept V rows, scale and importance columns, the appended row)."""
    from spatten_tpu_torch.ops.quantize import pack_unit
    m = cfg.model
    hkv, d, g = m.num_kv_heads, m.head_dim, m.q_heads_per_kv
    cap = cfg.engine.cache_capacity
    u = pack_unit(cap)
    byts = flops = 0
    for bi, n in enumerate(lengths):
        rows = sum(min(max(n - unit * u, 0), u // 2)
                   for unit in range(cap // u))
        for h in range(hkv):
            fired = bool(need[bi][h])
            kept = int(keep_any_tokens[bi][h])
            byts += (rows * d if quant else 0) + (n * d if fired or not quant
                                                  else 0)
            byts += n * 4 * 2 + n * 4                # k scale, imp r/w
            byts += kept * (d + 4)                   # V rows + scales
            byts += 3 * d + 8 + d                    # append (+ msb RMW)
            passes = (1 if quant else 0) + (1 if fired or not quant else 0)
            flops += g * (2 * d * n * passes + 5 * n * passes + 2 * d * kept)
    b = len(lengths)
    byts += 4 * b * (hkv * g * d * 2 + 2 * hkv * d) + b * hkv * 5
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", byts, flops)


def phase_k1(cfg, dev):
    from spatten_tpu_torch.models.transformer import v_keep_budgets
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base, q, k_new, v_new, lengths = k1_inputs(cfg, dev, gen)
    layer = 5
    m, p = cfg.model, cfg.pruning
    vb = p.v_block_size
    vkeep = v_keep_budgets(cfg, cfg.engine.cache_capacity)
    kw = dict(sm_scale=1.0 / math.sqrt(m.head_dim), quant_enabled=True,
              v_keep=vkeep, v_block_size=vb, layer=layer,
              importance_ema=p.importance_ema)

    def call(fn, st, threshold, **extra):
        return fn(q, st.cache.k, st.cache.v, k_new, v_new, lengths,
                  requant_threshold=threshold, importance_in=st.importance,
                  **kw, **extra)

    # a threshold midway across the widest gap near the median max prob
    probe = call(fd.fused_decode_attention_plain, base.clone(), 0.0)[1]
    mp = torch.sort(probe.max_prob.flatten()).values.cpu().numpy()
    lo, hi = len(mp) // 4, 3 * len(mp) // 4
    i = lo + int(np.argmax(mp[lo + 1:hi + 1] - mp[lo:hi])) + 1
    threshold = float(mp[i - 1] + mp[i]) / 2

    st_k, st_p = base.clone(), base.clone()
    b, hq = q.shape[:2]
    nvb = cfg.engine.cache_capacity // vb
    keep_k = torch.zeros((b, hq, nvb), dtype=torch.uint8, device=dev)
    out_k, stats_k, _, _ = call(fd.fused_decode_attention, st_k, threshold,
                                keep_out=keep_k)
    out_p, stats_p, _, _ = call(fd.fused_decode_attention_plain, st_p,
                                threshold)
    torch.cuda.synchronize()

    # planes after the append: exact, every layer
    for name in ("full", "msb", "scale"):
        for a, c in ((st_k.cache.k, st_p.cache.k), (st_k.cache.v, st_p.cache.v)):
            if getattr(a, name) is not None:
                check(torch.equal(getattr(a, name), getattr(c, name)),
                      f"K1 {name} plane differs from the plain version")
    # requant decisions: exact unless the max prob is within the margin
    near_t = (stats_p.max_prob - threshold).abs() < DECISION_MARGIN
    flips = stats_k.need_requant != stats_p.need_requant
    check(not bool((flips & ~near_t).any()), "K1 need_requant differs")
    fired = int(stats_k.need_requant.sum())
    check(0 < fired < stats_k.need_requant.numel(),
          f"threshold {threshold} fires {fired} heads")
    # V-block keep sets: plain decisions from the reference probabilities
    probs = stats_p.probs[:, :, 0]                       # [B, Hq, C]
    mass = probs.reshape(b, hq, nvb, vb).sum(-1)
    kb = max(1, -(-vkeep[layer] // vb))
    srt = torch.sort(mass, dim=-1, descending=True).values
    kth, nxt = srt[..., kb - 1:kb], srt[..., kb:kb + 1]
    keep_p = (mass >= kth) & (mass > 0)
    margin = torch.where(keep_p, mass - nxt, kth - mass)
    group = m.q_heads_per_kv
    # a row is ambiguous when its k-th and (k+1)-th block masses nearly
    # tie (with fewer live blocks than k, kth == 0 and all live are kept)
    row_near = ((kth - nxt)[..., 0] < DECISION_MARGIN) & (kth[..., 0] > 0)
    row_near |= near_t.repeat_interleave(group, dim=1)
    bad = (keep_k.bool() != keep_p) & (margin >= DECISION_MARGIN) \
        & ~row_near[..., None]
    check(not bool(bad.any()), f"K1 keeps {int(bad.sum())} V blocks "
          "differently from the plain version")
    # values on rows whose decisions are clear
    ok_rows = ~row_near
    err = (out_k - out_p).abs()[..., 0, :].amax(-1)       # [B, Hq]
    check(bool(torch.allclose(out_k[ok_rows], out_p[ok_rows], **K1_OUT_TOL)),
          "K1 out differs")
    check(bool(torch.allclose(stats_k.max_prob, stats_p.max_prob,
                              **K1_MAXP_TOL)), "K1 max_prob differs")
    head_ok = ~near_t
    for bi, n in enumerate(lengths.tolist()):
        a = st_k.importance[layer, bi, :, :n][head_ok[bi]]
        c = st_p.importance[layer, bi, :, :n][head_ok[bi]]
        check(bool(torch.allclose(a, c, **K1_IMP_TOL)), "K1 importance differs")
    max_err = float(err[ok_rows].max())
    log(f"K1 vs plain: ok (threshold {threshold:.6f} fires {fired}/"
        f"{stats_k.need_requant.numel()} heads; near-margin heads "
        f"{int(near_t.sum())}, near-margin rows {int(row_near.sum())}; "
        f"max |out err| {max_err:.3e})")

    # timing: the same inputs in every layer, walked in layer order so
    # each call finds its planes cold in L2, as decode does
    st_t = base.clone()
    n_layers = m.num_layers

    def kernel_call(i):
        fd.fused_decode_attention(
            q, st_t.cache.k, st_t.cache.v, k_new, v_new, lengths,
            requant_threshold=threshold, importance_in=st_t.importance,
            **dict(kw, layer=i % n_layers))

    def plain_call(i):
        fd.fused_decode_attention_plain(
            q, st_t.cache.k, st_t.cache.v, k_new, v_new, lengths,
            requant_threshold=threshold, importance_in=st_t.importance,
            **dict(kw, layer=i % n_layers))

    ms = device_ms(kernel_call, 4 * n_layers)
    plain_ms = device_ms(plain_call, n_layers)
    keep_blk = keep_k.bool().reshape(b, m.num_kv_heads, group, nvb).any(2)
    cap = cfg.engine.cache_capacity
    live = torch.arange(cap, device=dev)[None, None, :] < lengths[:, None, None]
    kept_tokens = (keep_blk.repeat_interleave(vb, dim=-1) & live).sum(-1
                                                                      ).tolist()
    bound_ms, bound_by, byts, flops = k1_bound(
        cfg, lengths.tolist(), stats_k.need_requant.tolist(), kept_tokens)
    log(f"K1 timing: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, bound "
        f"{bound_ms:.4f} ms ({bound_by}: {byts} B, {flops} flop)")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


# ---------------------------------------------------------------- phase 3
def phase_k2(cfg, dev):
    from spatten_tpu_torch.ops import compact_gather as cg
    m, p = cfg.model, cfg.pruning
    b, cap, hkv, d = 4, cfg.engine.cache_capacity, m.num_kv_heads, m.head_dim
    f = hkv * d
    keep_max = p.start_size + p.important_size + p.recent_size
    rng = np.random.default_rng(SEED)
    lengths = np.array([1024, 1024, 900, 1000], np.int32)
    triggered = np.array([1, 0, 1, 1], np.int32)
    keep_count = np.array([keep_max, keep_max, 600, keep_max], np.int32)
    idx = np.zeros((b, hkv, keep_max), np.int32)
    for bi in range(b):
        n = keep_count[bi]
        for h in range(hkv):
            start = np.arange(p.start_size)
            mid = np.sort(rng.choice(np.arange(p.start_size, lengths[bi]),
                                     n - p.start_size, replace=False))
            idx[bi, h, :n] = np.concatenate([start, mid])
    keep_idx = torch.from_numpy(idx).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    trig_t = torch.from_numpy(triggered).to(dev)
    kc_t = torch.from_numpy(keep_count).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_rot = 8                                  # planes walked for timing
    k_all = torch.randint(-127, 128, (n_rot, b, cap, f), generator=gen,
                          device=dev, dtype=torch.int8)
    v_all = torch.randint(-127, 128, (n_rot, b, cap, f), generator=gen,
                          device=dev, dtype=torch.int8)
    k0, v0 = k_all[0].clone(), v_all[0].clone()

    kk, vk = k0.clone(), v0.clone()
    kp, vp = k0.clone(), v0.clone()
    cg.gather_compact_rows(kk, vk, keep_idx, lens_t, trig_t,
                           keep_count=kc_t, window=cap)
    cg.gather_compact_rows_plain(kp, vp, keep_idx, lens_t, trig_t,
                                 keep_count=kc_t, window=cap)
    torch.cuda.synchronize()
    max_err = 0
    for bi in range(b):
        n = int(keep_count[bi]) if triggered[bi] else cap
        for a, c, o in ((kk, kp, k0), (vk, vp, v0)):
            check(torch.equal(a[bi, :n], c[bi, :n]),
                  f"K2 live rows differ (b={bi})")
            check(torch.equal(a[bi, n:], o[bi, n:]),
                  f"K2 touched rows past the keep count (b={bi})")
            max_err = max(max_err, int((a[bi, :n].int() - c[bi, :n].int())
                                       .abs().max()))
    log("K2 vs plain: byte-exact on live rows, untouched elsewhere")

    def kernel_call(i):
        cg.gather_compact_rows(k_all[i % n_rot], v_all[i % n_rot], keep_idx,
                               lens_t, trig_t, keep_count=kc_t, window=cap)

    def plain_call(i):
        cg.gather_compact_rows_plain(
            k_all[i % n_rot], v_all[i % n_rot], keep_idx, lens_t, trig_t,
            keep_count=kc_t, window=cap)

    gidx = keep_idx.to(torch.int64).transpose(1, 2)[..., None].expand(
        b, keep_max, hkv, d)

    def library_call(i):
        torch.gather(k_all[i % n_rot].view(b, cap, hkv, d), 1, gidx)
        torch.gather(v_all[i % n_rot].view(b, cap, hkv, d), 1, gidx)

    ms = device_ms(kernel_call, 4 * n_rot)
    plain_ms = device_ms(plain_call, n_rot)
    library_ms = device_ms(library_call, 4 * n_rot)
    moved = 0
    for bi in range(b):
        if triggered[bi]:
            n = keep_count[bi]
            moved += int((idx[bi, :, :n] != np.arange(n)[None]).sum())
    byts = moved * d * 2 * 2 + int((keep_count * triggered).sum()) * hkv * 4
    bound_ms = byts / HBM_BYTES_PER_S * 1e3
    log(f"K2 timing: {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
        f"{library_ms:.4f} ms torch.gather (K and V), bound {bound_ms:.4f} ms "
        f"(bytes: {moved} moved head rows, {byts} B)")
    return dict(max_abs_err=float(max_err), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


# ---------------------------------------------------------------- phase 4
def small_reference_check(dev):
    """A small GQA model (head_dim 64, group 2) in f32: the kernels vs the
    plain versions, both on the card, from the same weights and prompt.
    Prefill (three prunes, through K2 or the gather) must give equal
    logits; then five decode windows (a decode prune before the fourth;
    K1 every step) fed the plain path's tokens, step by step."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    cfg = SpAttenConfig(
        model=ModelConfig(vocab_size=512, hidden_size=256, num_layers=3,
                          num_heads=4, num_kv_heads=2, head_dim=64,
                          intermediate_size=512),
        pruning=PruningConfig(start_size=4, important_size=16,
                              recent_size=32, v_block_size=16),
        quant=QuantConfig(requant_threshold=0.1),
        engine=EngineConfig(max_batch_size=2, cache_capacity=128,
                            prefill_chunk=32, decode_window=16),
    ).validate()
    cfgs = {"kernel": cfg, "plain": dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, use_pallas=False))}
    params = tr.init_params(cfg.model, SEED, dtype=torch.float32, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 512, (2, 280))).to(dev)
    state, last = {}, {}
    for k, c in cfgs.items():
        last[k], state[k], host, pruned = gen.prefill(
            params, c, init_state(c, 2, device=dev), prompt)
    err = float((last["kernel"] - last["plain"]).abs().max())
    check(len(pruned) == 3, f"small model prefill pruned {pruned}")
    check(err <= 1e-5, f"small model prefill logits differ: {err}")
    tok = torch.argmax(last["plain"], -1).to(torch.int32)
    steps = gen.decode_window_steps(cfg)
    step_err, fired = [], {"kernel": 0, "plain": 0}
    for w in range(5):
        layers, host = gen.prune_schedule_step(cfg, host, steps)
        for k, c in cfgs.items():
            if layers:
                state[k], _ = gen.maybe_prune(c, state[k], steps,
                                              static_layers=layers)
        for _ in range(steps):
            logits = {}
            for k, c in cfgs.items():
                lg, state[k], aux = tr.forward(params, c, state[k],
                                               tok[:, None])
                logits[k] = lg[:, -1]
                fired[k] += int(aux.requant_events)
            step_err.append(float((logits["kernel"] - logits["plain"])
                                  .abs().max()))
            tok = torch.argmax(logits["plain"], -1).to(torch.int32)
    good = float(np.mean(np.asarray(step_err) <= SMALL_STEP_TOL))
    check(good >= SMALL_STEPS_MIN, f"small model: only {good:.2f} of decode "
          f"steps agree within {SMALL_STEP_TOL}")
    log(f"small model (f32, card kernels vs card plain): largest logit "
        f"{float(last['plain'].abs().max()):.2f}; prefill logits max |diff| "
        f"{err:.2e}; decode steps within {SMALL_STEP_TOL}: {good:.3f} of "
        f"{len(step_err)} (median {float(np.median(step_err)):.2e}, max "
        f"{max(step_err):.2e}); requant events {fired['kernel']} vs "
        f"{fired['plain']}")


def phase_main(cfg, dev):
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops import rope as rope_ops
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    m = cfg.model
    batch, prompt_len, new_tokens = 4, 1152, 128
    t0 = time.perf_counter()
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + \
        params["embed"].numel() + params["lm_head"].numel()
    log(f"params: {n_params / 1e9:.2f} B bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(SEED).integers(
        0, m.vocab_size, (batch, prompt_len))

    # expected prune schedule (host-side, pure arithmetic)
    lens, points = [0] * m.num_layers, 0
    for pos in range(0, prompt_len, cfg.engine.prefill_chunk):
        layers, lens = gen.prune_schedule_step(
            cfg, lens, min(cfg.engine.prefill_chunk, prompt_len - pos))
        points += len(layers)
    steps = gen.decode_window_steps(cfg)
    for w in range(0, new_tokens, steps):
        layers, lens = gen.prune_schedule_step(
            cfg, lens, min(steps, new_tokens - w))
        points += len(layers)

    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    res = gen.generate(params, cfg, prompt, new_tokens, device=dev)
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    tokens = res.tokens
    check(tuple(tokens.shape) == (batch, new_tokens), "token shape")
    check(bool(((tokens >= 0) & (tokens < m.vocab_size)).all()),
          "tokens out of range")
    check(k1 == m.num_layers * new_tokens and k1 > 0,
          f"K1 launched {k1} times, expected {m.num_layers * new_tokens}")
    check(k2 == points and k2 > 0, f"K2 launched {k2} times, expected "
          f"{points}")
    check(res.state.layer_lengths.tolist() == [[lens[l]] * batch
                                               for l in range(m.num_layers)],
          "layer lengths differ from the schedule")
    tok_s = batch * new_tokens / res.decode_seconds
    log(f"main path: prefill {res.prefill_seconds:.3f} s "
        f"({batch}x{prompt_len} tokens), decode {res.decode_seconds:.3f} s "
        f"= {tok_s:.1f} tok/s ({batch}x{new_tokens} tokens); prune points "
        f"{len(res.pruned_layers)} ({k2} layer compactions); requant events "
        f"{int(res.requant_events)}; K1 launches {k1}, K2 launches {k2}")

    # first decode window again: kernels, then the plain versions on the
    # card from the same post-prefill state, fed the same tokens
    state = init_state(cfg, batch, device=dev)
    last, state, _, _ = gen.prefill(params, cfg, state,
                                    torch.as_tensor(prompt, device=dev))
    snap = state.clone()
    tables = rope_ops.rope_table(cfg.engine.cache_capacity, m.head_dim,
                                 m.rope_theta, dev)
    tok = torch.argmax(last, -1).to(torch.int32)
    fed, logits_k = [], []
    for _ in range(steps):
        logits, state, _ = tr.forward(params, cfg, state, tok[:, None], tables)
        fed.append(tok)
        logits_k.append(logits[:, -1])
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    cfg_plain = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, use_pallas=False))
    state, logits_p = snap, []
    for t in fed:
        logits, state, _ = tr.forward(params, cfg_plain, state, t[:, None],
                                      tables)
        logits_p.append(logits[:, -1])
    lk, lp = torch.stack(logits_k), torch.stack(logits_p)   # [steps, B, V]
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    step_err = (lk - lp).abs().amax(dim=(1, 2)).tolist()
    mean_err = float((lk - lp).abs().mean())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    same = bool(torch.equal(torch.stack(fed, 1), tokens[:, :steps]))
    log(f"first decode window, kernels vs plain on the card ({steps} steps, "
        f"same tokens fed): mean |logit diff| {mean_err:.2e} (tolerance "
        f"{WINDOW_MEAN_TOL}); argmax agreement {agree:.4f} (min "
        f"{WINDOW_ARGMAX_MIN}); max |diff| by step "
        f"{[round(step_err[i], 4) for i in (0, 1, 2, 4, 8, 16, 32, steps - 1)]}"
        f" (largest logit {float(lk.abs().max()):.2f}); the rerun "
        f"reproduces generate's tokens: {same}")
    check(mean_err <= WINDOW_MEAN_TOL, f"window mean error {mean_err}")
    check(agree >= WINDOW_ARGMAX_MIN, f"argmax agreement {agree}")
    profile_decode(params, cfg, state, tok, tables,
                   res.decode_seconds / new_tokens)
    return k1, k2


def profile_decode(params, cfg, state, tok, tables, step_s: float,
                   steps: int = 8) -> None:
    """Device time per decode step, by kernel, from a torch.profiler trace
    of a few kernel-path steps, against the host-clock step time of the
    unprofiled ``generate`` run: the device's busy and idle shares."""
    from torch.profiler import ProfilerActivity, profile
    from spatten_tpu_torch.models import transformer as tr
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state, _ = tr.forward(params, cfg, state, tok[:, None],
                                          tables)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's entry repeats the device
        # time of the kernels it launched
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = ev.self_device_time_total / 1e3 / steps
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t
    if not by_name:
        log("profile: the trace holds no device time (not measured)")
        return
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"profile ({steps} decode steps, kernel path): device time "
        f"{dev_ms:.3f} ms/step vs {step_s * 1e3:.3f} ms/step host clock in "
        f"generate -> device busy {dev_ms / (step_s * 1e3):.3f}, idle "
        f"{1 - dev_ms / (step_s * 1e3):.3f}; top: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import spatten_tpu_torch  # noqa: F401  (fails outside the repository)
    from spatten_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    secs, reports = kernels.build_all(force=True)
    log(f"built {sorted(reports)} in {secs:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    cfg = slice_config()
    k1_stats = phase_k1(cfg, dev)
    k2_stats = phase_k2(cfg, dev)
    small_reference_check(dev)
    k1, k2 = phase_main(cfg, dev)

    out = {"kernels": [
        dict(name="fused_decode_attention", route="cuda",
             source="spatten_tpu_torch/csrc/fused_decode.cu",
             replaces="spatten_tpu/ops/fused_decode.py:2319",
             launches=k1, **k1_stats),
        dict(name="gather_compact_rows", route="cuda",
             source="spatten_tpu_torch/csrc/compact_gather.cu",
             replaces="spatten_tpu/ops/compact_gather.py:335",
             launches=k2, **k2_stats),
    ]}
    log("library_ms: fused_decode_attention has no single PyTorch call "
        "computing its function (append + 4-bit scoring + requant + "
        "importance + V top-k); gather_compact_rows is timed against two "
        "torch.gather calls (K and V planes, out of place)")
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
