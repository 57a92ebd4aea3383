"""Phase breakdown of the decode step at a bench point (port of
``tools/profile_decode.py``).

    python -m spatten_tpu_torch.tools.profile_decode [MODE] [cache] [batch]

MODE (default ``spatten``; cache x batch default 16384 x 32,
``SPATTEN_BENCH_STEPS`` steps a window, default 64):

* ``spatten`` / ``dense``: a phase ladder of decode windows
  (``timed_window``: ``forward`` steps only, no prune or head-mask work),
  each row switching one more SpAtten stage off (requant, V pruning,
  head pruning, token pruning); the differences price the stages;
* ``kernel`` / ``kernel-dense``: K1 alone (``timed_kernel_only``: a
  window of steps x layers K1 calls over the warmed stacked planes, no
  projections, MLP or lm_head);
* ``kernel-ladder``: K1 alone with the append skipped (K1's
  ``_skip_append``), importance off, requant off, V pruning off, and all
  of these.

Each decode window is timed on the host clock (``min`` over
``repeats``), as the JAX tool times its scanned windows; the K1-only
windows on the card's clock (``microbench.loop_time``), since eager K1
calls are host-bound.  With ``SPATTEN_PROFILE_TRACE`` set,
the ladder modes also record one window of 8 steps under torch.profiler
into ``build/profile_trace/`` (git-ignored; a Chrome trace for
Perfetto) and print the device time per step by kernel, the device's busy
share of the host step, and the share of the int8 -> bf16 weight casts
that ``models/weight_quant.matmul`` issues.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path

import torch

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
from spatten_tpu_torch.tools import bench
from spatten_tpu_torch.tools.microbench import loop_time

TRACE_DIR = Path(__file__).resolve().parents[2] / "build" / "profile_trace"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _warm(cfg, dev):
    b = cfg.engine.max_batch_size
    return bench.warm_cache_content(cfg, bench.warm_state(
        cfg, init_state(cfg, batch=b, device=dev)))


def _best_ms(run, steps: int, repeats: int) -> float:
    """ms per step of the fastest of ``repeats`` calls of ``run`` (each
    ending in a host read) after one untimed call."""
    run()
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best / steps * 1e3


def timed_window(cfg, params, steps=64, repeats=3, *, device="cuda"):
    """ms per decode step of a window of ``steps`` greedy ``forward``
    steps over the warmed cache."""
    dev = resolve_device(device)
    b = cfg.engine.max_batch_size
    carry = [_warm(cfg, dev), torch.zeros((b,), dtype=torch.int32,
                                          device=dev)]
    tables = rope_ops.rope_table(cfg.engine.cache_capacity,
                                 cfg.model.head_dim, cfg.model.rope_theta,
                                 dev)

    def run():
        state, token = carry
        for _ in range(steps):
            logits, state, _ = transformer.forward(
                params, cfg, state, token[:, None], rope_tables=tables)
            token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        carry[:] = [state, token]
        token.cpu()

    return _best_ms(run, steps, repeats)


def timed_kernel_only(cfg, steps=64, repeats=3, skip_append=False,
                      no_importance=False, *, device="cuda"):
    """ms per step of K1 alone: ``steps`` x layers calls of
    ``fused_decode_attention`` over the warmed stacked planes, at each
    layer's warm length + 1, with ones for queries and new rows -- no
    projections, MLP or lm_head.  Isolates the kernel from the model; on
    the card the calls queue behind a sleep (``microbench.loop_time``),
    so the time is the card's, not the host's launch rate."""
    dev = resolve_device(device)
    m, e, p, q = cfg.model, cfg.engine, cfg.pruning, cfg.quant
    b = e.max_batch_size
    state = _warm(cfg, dev)
    v_keep = transformer.v_keep_budgets(cfg, e.cache_capacity)
    qh = torch.ones((b, m.num_heads, 1, m.head_dim), device=dev)
    kh = torch.ones((b, m.num_kv_heads, 1, m.head_dim), device=dev)
    lengths = state.layer_lengths + 1
    threshold = q.requant_threshold if q.enabled and q.enable_requant else 0.0

    def step(_):
        for layer in range(m.num_layers):
            fused_decode_attention(
                qh, state.cache.k, state.cache.v, kh, kh, lengths[layer],
                sm_scale=0.088, quant_enabled=q.enabled,
                requant_threshold=threshold, v_keep=v_keep,
                v_block_size=p.v_block_size, pv_int8=q.pv_int8,
                importance_in=None if no_importance else state.importance,
                track_importance=not no_importance, layer=layer,
                quantize_queries=q.quantize_queries,
                _skip_append=skip_append)

    return loop_time(step, None, steps, dev, repeats) * 1e3


def kernel_ladder(cfg) -> list:
    """(name, timed_kernel_only keywords, config) of the kernel ladder, in
    the JAX tool's order."""
    no_rq = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, requant_threshold=0.0, enable_requant=False))
    return [
        ("baseline", {}, cfg),
        ("skip_append", dict(skip_append=True), cfg),
        ("no_importance", dict(no_importance=True), cfg),
        ("no requant", {}, no_rq),
        ("no vprune", {}, dataclasses.replace(
            cfg, pruning=dataclasses.replace(cfg.pruning,
                                             enable_v_pruning=False))),
        ("bare (all off)", dict(skip_append=True, no_importance=True),
         dataclasses.replace(no_rq, pruning=dataclasses.replace(
             cfg.pruning, enable_v_pruning=False))),
    ]


def phase_ladder(cfg) -> list:
    """(name, config) of the spatten phase ladder after its full row."""
    p, q = cfg.pruning, cfg.quant
    c = dataclasses.replace(cfg, quant=dataclasses.replace(
        q, requant_threshold=0.0, enable_requant=False))
    c2 = dataclasses.replace(c, pruning=dataclasses.replace(
        p, enable_v_pruning=False))
    c3 = dataclasses.replace(c2, pruning=dataclasses.replace(
        c2.pruning, enable_head_pruning=False, head_keep=0,
        head_update_interval=0))
    c4 = dataclasses.replace(c3, pruning=dataclasses.replace(
        c3.pruning, enable_token_pruning=False))
    return [("- requant (threshold=0)", c), ("- requant - vprune", c2),
            ("- requant - vprune - headprune", c3),
            ("- all pruning (quant only, full len)", c4)]


def _calibrated(cfg, params, dev):
    thr = bench.calibrate_requant(cfg, params, device=dev)
    return dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, requant_threshold=thr))


TRACE_STEPS = 8


def trace_window(cfg, params, dev) -> dict:
    """One window of TRACE_STEPS decode steps under torch.profiler, written
    to ``TRACE_DIR`` (after an untimed window and a timed one without the
    profiler): device ms per step by kernel, the host ms per step of the
    unprofiled window, and the int8 -> bf16 casts' share."""
    from spatten_tpu_torch.utils.profiling import profile_trace
    b = cfg.engine.max_batch_size
    state = _warm(cfg, dev)
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    tables = rope_ops.rope_table(cfg.engine.cache_capacity,
                                 cfg.model.head_dim, cfg.model.rope_theta,
                                 dev)

    def window(state, token):
        for _ in range(TRACE_STEPS):
            logits, state, _ = transformer.forward(
                params, cfg, state, token[:, None], rope_tables=tables)
            token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        token.cpu()
        return state, token

    state, token = window(state, token)
    t0 = time.perf_counter()
    state, token = window(state, token)
    host_ms = (time.perf_counter() - t0) / TRACE_STEPS * 1e3   # unprofiled
    log(f"capturing profiler trace to {TRACE_DIR} ...")
    with profile_trace(str(TRACE_DIR)) as prof:
        state, token = window(state, token)
    by_kernel, casts = {}, 0.0
    per_step = 1e3 * TRACE_STEPS                       # us -> ms a step
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.key] = (by_kernel.get(ev.key, 0.0)
                                 + ev.self_device_time_total / per_step)
        elif ev.key == "aten::_to_copy":
            # the casts' kernels, charged to the op that launched them
            casts += ev.device_time_total / per_step
    dev_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    print(f"trace ({TRACE_STEPS} steps): device {dev_ms:.3f} ms/step busy "
          f"of {host_ms:.3f} ms/step on the host (an unprofiled window; busy "
          f"share {dev_ms / host_ms:.3f}); int8 -> bf16 casts "
          "(aten::_to_copy) "
          f"{casts:.3f} ms/step = {casts / max(dev_ms, 1e-9):.3f} of the "
          "device time")
    for name, ms in top:
        print(f"  {ms:8.3f} ms/step  {name[:90]}")
    return dict(device_ms=dev_ms, host_ms=host_ms, cast_ms=casts,
                top=top)


def main(argv=None, device="cuda") -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device(device)
    mode = argv[0] if len(argv) > 0 else "spatten"
    cache = int(argv[1]) if len(argv) > 1 else 16384
    batch = int(argv[2]) if len(argv) > 2 else 32
    steps = int(os.environ.get("SPATTEN_BENCH_STEPS", 64))

    params = bench.bench_params(dev)

    cfg = bench.build_cfg(mode == "spatten", cache, batch)
    if mode == "spatten":
        cfg = _calibrated(cfg, params, dev)

    rows = []
    if mode in ("kernel", "kernel-dense"):
        cfg = bench.build_cfg(mode == "kernel", cache, batch)
        if mode == "kernel":
            cfg = _calibrated(cfg, params, dev)
        ms = timed_kernel_only(cfg, steps, device=dev)
        print(f"kernel-only ({mode}): {ms:.3f} ms/step")
        return [(mode, ms)]

    if mode == "kernel-ladder":
        cfg = _calibrated(bench.build_cfg(True, cache, batch), params, dev)
        for name, kw, c in kernel_ladder(cfg):
            ms = timed_kernel_only(c, steps, device=dev, **kw)
            rows.append((name, ms))
            print(f"  kernel {name:24s} {ms:8.3f} ms/step", flush=True)
        return rows

    def point(name, c):
        ms = timed_window(c, params, steps, device=dev)
        rows.append((name, ms))
        log(f"{name:40s} {ms:8.3f} ms/step")

    point(f"{mode} full", cfg)
    if mode == "spatten":
        for name, c in phase_ladder(cfg):
            point(name, c)

    if os.environ.get("SPATTEN_PROFILE_TRACE"):
        trace_window(cfg, params, dev)

    print("phase ladder (ms/step):")
    prev = None
    for name, ms in rows:
        delta = "" if prev is None else f"   (marginal {prev - ms:+.3f})"
        print(f"  {name:42s} {ms:8.3f}{delta}")
        prev = ms
    return rows


if __name__ == "__main__":
    main()
