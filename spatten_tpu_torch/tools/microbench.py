"""Microbenchmarks on the card (port of ``tools/microbench.py``).

    python -m spatten_tpu_torch.tools.microbench bw      # bandwidth vs size
    python -m spatten_tpu_torch.tools.microbench kernel  # K1 variant sweep
    python -m spatten_tpu_torch.tools.microbench 8k      # K1 at 8192 tokens
    python -m spatten_tpu_torch.tools.microbench floor   # K1 without append

The JAX tool ran N iterations inside one jitted ``lax.scan`` to get past
a per-dispatch floor; here each measurement is N back-to-back eager
launches (no CUDA graph) between two CUDA events, queued behind a sleep
kernel so that the events time the card and not the host's launch rate
(an eager K1 call costs ~0.2 ms of host time), after one warm-up call,
and reports the fastest of 5 repeats per iteration (``loop_time``).
``bw`` times torch ops (reads, fills, copies, the int8 -> bf16 weight-
streaming product ``models/weight_quant.matmul`` computes, a bf16
matmul); the other modes time K1 (``kernel_case``: one layer of
``init_stacked_cache(1, b, 4, cap, 128)`` planes, 4 query heads over 4
kv heads of 128, v_block 64, int8 queries, at a fixed length). The JAX
tool's ``_hpp_override`` knob picks heads per Pallas program; K1's grid
is one CTA per (batch row, kv head), so ``kernel_case`` has no ``hpp``.
"""

from __future__ import annotations

import sys
import time

import torch

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.engine.kv_cache import init_stacked_cache
from spatten_tpu_torch.ops.fused_decode import fused_decode_attention

MB = 1 << 20


def log(msg):
    print(msg, flush=True)


def loop_time(fn, carry, n: int, device="cuda", repeats: int = 5) -> float:
    """Seconds per iteration of ``carry = fn(carry)`` run ``n`` times back
    to back, the fastest of ``repeats``.  On the card the launches queue
    behind a ``torch.cuda._sleep`` sized from the host's own time for the
    ``n`` calls, so the CUDA events around them time the card's work, not
    the host's launch rate; on the CPU the host clock times the calls."""
    dev = resolve_device(device)
    carry = fn(carry)                       # warm-up
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(n):
        carry = fn(carry)
    if cuda:
        torch.cuda.synchronize(dev)
    host_s = time.perf_counter() - t0
    if not cuda:
        return host_s / n
    best = float("inf")
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(int(max(2e8, 4e9 * host_s)))
        ev[0].record()
        for _ in range(n):
            carry = fn(carry)
        ev[1].record()
        ev[1].synchronize()
        best = min(best, ev[0].elapsed_time(ev[1]) / 1e3)
    return best / n


def bench_bw(device="cuda", sizes=((16, 64, 256), (1, 8, 64)),
             dot_shape=(8, 4096, 8192, 16)) -> dict:
    """Read (``sizes[0]`` MB), write and copy (``sizes[1]`` MB) bandwidth
    against size; the int8 -> bf16 weight-streaming product over L
    stacked layers (``dot_shape``: L, k, n, rows); a 4k bf16 matmul."""
    dev = resolve_device(device)
    out = {}
    for mb in sizes[0]:
        x = torch.ones((mb * 1024, 1024), dtype=torch.int8, device=dev)
        dt = loop_time(lambda c, x=x: c + x.sum(dtype=torch.float32),
                       torch.zeros((), device=dev), 16, dev)
        out[f"read {mb}"] = mb / 1024 / dt
        log(f"scanned read {mb:4d} MB: {mb / 1024 / dt:7.1f} GB/s"
            f"  ({dt * 1e3:.3f} ms/iter)")
    for mb in sizes[1]:
        x = torch.zeros((mb * 1024, 1024), dtype=torch.int8, device=dev)
        dt = loop_time(lambda c: (c[0].fill_(1), c[1]), (x, None), 16, dev)
        out[f"write {mb}"] = mb / 1024 / dt
        log(f"scanned write {mb:4d} MB: {mb / 1024 / dt:7.1f} GB/s"
            f"  ({dt * 1e3:.3f} ms/iter)")
    for mb in sizes[1]:
        x = torch.zeros((mb * 1024, 1024), dtype=torch.int8, device=dev)
        dt = loop_time(lambda c: (c[0] + 1, None), (x, None), 16, dev)
        out[f"r+w {mb}"] = 2 * mb / 1024 / dt
        log(f"scanned r+w  {mb:4d} MB: {2 * mb / 1024 / dt:7.1f} GB/s agg"
            f"  ({dt * 1e3:.3f} ms/iter)")
    n_layers, k, nn, rows = dot_shape
    w = torch.ones((n_layers, k, nn), dtype=torch.int8, device=dev)
    a = torch.ones((rows, k), dtype=torch.bfloat16, device=dev)

    def stream(x):
        for layer in range(n_layers):
            x = torch.matmul(x, w[layer].to(torch.bfloat16))[:, :k]
        return x

    dt = loop_time(stream, a, 16, dev)
    nbytes = n_layers * k * nn
    out["int8-dot stream"] = nbytes / 2**30 / dt
    log(f"scanned int8-dot stream rows={rows}: "
        f"{nbytes / 2**30 / dt:7.1f} GB/s  ({dt * 1e3:.3f} ms/iter, "
        f"{nbytes // 2**20} MB weights)")
    a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
    bm = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
    dt = loop_time(lambda c: torch.matmul(c, bm) * 1e-3, a, 8, dev)
    out["bf16 matmul"] = 2 * 4096 ** 3 / dt / 1e12
    log(f"scanned bf16 4k matmul: {2 * 4096 ** 3 / dt / 1e12:7.1f} TFLOP/s"
        f"  ({dt * 1e3:.3f} ms/iter)")
    return out


def kernel_case(name, *, batch=16, cap=4096, spatten=False, quant=None,
                requant=None, vprune=None, imp=None, steps=256,
                length=None, threshold=0.05, skip_append=False,
                device="cuda"):
    """Seconds per K1 call over one layer's planes (``steps`` calls back
    to back at a fixed length, each appending at the same slot)."""
    dev = resolve_device(device)
    hq = hkv = 4
    dh = 128
    b = batch
    quant = spatten if quant is None else quant
    requant = spatten if requant is None else requant
    vprune = spatten if vprune is None else vprune
    imp = spatten if imp is None else imp

    stacked = init_stacked_cache(1, b, hkv, cap, dh, device=dev)
    kq, vq = stacked.k.layer(0), stacked.v.layer(0)
    length = int(cap * 0.9) if length is None else length
    lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
    impbuf = torch.zeros((b, hkv, cap), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    qv = torch.randn((b, hq, 1, dh), generator=gen, device=dev)
    knew = torch.randn((b, hkv, 1, dh), generator=gen, device=dev)

    def body(_):
        fused_decode_attention(
            qv, kq, vq, knew, knew, lengths, sm_scale=0.088,
            requant_threshold=threshold if requant else 0.0,
            quant_enabled=quant, v_keep=cap // 4 if vprune else 0,
            v_block_size=64, importance_in=impbuf if imp else None,
            quantize_queries=True, track_importance=imp,
            _skip_append=skip_append)

    dt = loop_time(body, None, steps, dev)
    log(f"kernel {name:32s}: {dt * 1e6:8.1f} us/call"
        f"  (b={batch} cap={cap})")
    return dt


def bench_kernel(device="cuda") -> dict:
    out = {}

    def kc(name, **kw):
        out[name] = kernel_case(name, device=device, **kw)

    kc("dense", spatten=False)
    kc("dense b=4", spatten=False, batch=4)
    kc("dense b=1", spatten=False, batch=1)
    kc("dense cap=1024", spatten=False, cap=1024)
    kc("spatten full allfire", spatten=True)
    kc("spatten full nofire", spatten=True, threshold=1e-9)
    kc("spatten len=1250 allfire", spatten=True, length=1250)
    kc("spatten len=1250 nofire", spatten=True, length=1250,
       threshold=1e-9)
    kc("spatten no-requant", spatten=True, requant=False)
    kc("spatten no-vprune", spatten=True, vprune=False)
    kc("spatten no-imp", spatten=True, imp=False)
    kc("quant-only", quant=True, requant=False, vprune=False, imp=False)
    kc("dense+imp", spatten=False, imp=True)
    kc("dense len=1250", spatten=False, length=1250)
    return out


def bench_8k(device="cuda") -> dict:
    out = {}

    def kc(name, **kw):
        out[name] = kernel_case(name, device=device, **kw)

    kc("dense 8k", spatten=False, cap=8192)
    kc("dense 8k b=32", spatten=False, cap=8192, batch=32)
    kc("spatten 8k len=2490 allfire", spatten=True, cap=8192, length=2490)
    kc("spatten 8k len=2490 nofire", spatten=True, cap=8192, length=2490,
       threshold=1e-9)
    kc("spatten 8k b=32 len=2490 nofire", spatten=True, cap=8192,
       batch=32, length=2490, threshold=1e-9)
    kc("spatten 8k b=32 len=2490 allfire", spatten=True, cap=8192,
       batch=32, length=2490)
    kc("sp 8k b=32 2490 nofire novp", spatten=True, cap=8192, batch=32,
       length=2490, threshold=1e-9, vprune=False)
    kc("sp 8k b=32 2490 nofire noimp", spatten=True, cap=8192, batch=32,
       length=2490, threshold=1e-9, imp=False)
    kc("sp 8k b=32 2490 norq", spatten=True, cap=8192, batch=32,
       length=2490, requant=False)
    kc("sp 8k b=32 2490 qonly", quant=True, cap=8192, batch=32,
       length=2490, requant=False, vprune=False, imp=False)
    kc("dense 8k b=32 len=2490", spatten=False, cap=8192, batch=32,
       length=2490)
    return out


def bench_floor(device="cuda") -> dict:
    out = {}

    def kc(name, **kw):
        out[name] = kernel_case(name, device=device, **kw)

    kc("dense", spatten=False)
    kc("dense no-append", spatten=False, skip_append=True)
    kc("dense len=1250 no-append", spatten=False, length=1250,
       skip_append=True)
    kc("spatten 1250 nofire no-append", spatten=True, length=1250,
       threshold=1e-9, skip_append=True)
    kc("dense len=128", spatten=False, length=128)
    kc("dense len=128 no-append", spatten=False, length=128,
       skip_append=True)
    return out


MODES = {"bw": bench_bw, "kernel": bench_kernel, "8k": bench_8k,
         "floor": bench_floor}


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv[0] if argv else "bw"
    if mode not in MODES:
        raise SystemExit(f"unknown mode {mode}")
    return MODES[mode](device=device)


if __name__ == "__main__":
    main()
