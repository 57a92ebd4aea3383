"""Memory bandwidth of the card, measured through torch ops (port of
``tools/hbm_calibrate.py``).

The roofline bounds in PERF.md divide bytes by the H100 SXM data sheet's
3.35 TB/s; this measures what the card reaches:

* read: a reduction over 512 MB at int8, bf16 and f32
  (``torch.sum(x, dtype=torch.float32)``: each byte read once, the cast
  inside the reduction);
* the int8 -> bf16 weight-streaming product ``[16|64, 4096] @ [4096,
  16384]`` as ``models/weight_quant.matmul`` computes it (the int8 matrix
  cast to bf16, then the product), in GB/s of int8 weights;
* copy: ``x + 1`` over 256 MB of int8 (read + write).

Each is timed with CUDA events around ``iters`` calls after a warm-up
call.  These are torch ops, not kernels of the port: they say what the
card's memory gives a plain op.

    python -m spatten_tpu_torch.tools.hbm_calibrate

runs on the card; ``calibrate(device="cpu", ...)`` at a small size runs
on the CPU when asked (host clock, for the tests), and the default raises
without CUDA.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

from spatten_tpu_torch.device import resolve_device

DATASHEET_GBPS = 3350.0          # H100 SXM HBM3 (NVIDIA data sheet)
MB = 1 << 20


def _seconds(fn, dev: torch.device, iters: int) -> float:
    """Seconds per call of ``fn`` after one warm-up call: CUDA events on
    the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize(dev)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def calibrate(device: str | torch.device = "cuda", *,
              read_bytes: int = 512 * MB, copy_bytes: int = 256 * MB,
              k: int = 4096, n: int = 16384, rows=(16, 64),
              iters: int = 10) -> list:
    """One dict per measurement: ``name``, ``bytes`` (the bytes the op
    must move: each input read once, each output written once; weights
    only for the product), ``ms`` and ``gbps``, and ``device``."""
    dev = resolve_device(device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu")
    out = []

    def put(name, nbytes, fn):
        s = _seconds(fn, dev, iters)
        out.append(dict(name=name, bytes=nbytes, ms=s * 1e3,
                        gbps=nbytes / s / 1e9, device=where))

    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16"),
                        (torch.float32, "f32")):
        elems = read_bytes // dtype.itemsize
        x = torch.ones((elems // 1024, 1024), dtype=dtype, device=dev)
        put(f"read {name}", read_bytes,
            lambda: torch.sum(x, dtype=torch.float32))
        del x
    w = torch.ones((k, n), dtype=torch.int8, device=dev)
    for r in rows:
        a = torch.ones((r, k), dtype=torch.bfloat16, device=dev)
        put(f"int8 dot rows={r}", k * n,
            lambda: torch.matmul(a, w.to(torch.bfloat16)).sum())
    del w
    x = torch.ones((copy_bytes // 1024, 1024), dtype=torch.int8, device=dev)
    put("copy int8 (r+w)", 2 * copy_bytes, lambda: x + 1)
    return out


def lines(results: list) -> list:
    """The JAX tool's lines, each with the share of the data sheet's
    3.35 TB/s."""
    out = []
    for r in results:
        share = f"{r['gbps'] / DATASHEET_GBPS:.3f} of 3350 GB/s"
        if r["name"].startswith("read"):
            out.append(f"{r['name']}: {r['gbps']:.1f} GB/s ({r['ms']:.3f} ms "
                       f"for {r['bytes'] // MB} MB; {share})")
        elif r["name"].startswith("int8 dot"):
            out.append(f"{r['name']}: {r['gbps']:.1f} GB/s of weights "
                       f"({r['ms']:.3f} ms for {r['bytes'] // MB} MB; "
                       f"{share})")
        else:
            half = r["bytes"] // 2 // MB
            out.append(f"{r['name']}: {r['gbps']:.1f} GB/s agg ({r['ms']:.3f}"
                       f" ms for {half} MB r + {half} MB w; {share})")
    return out


def main(argv=None) -> int:
    res = calibrate()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for line in lines(res):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
