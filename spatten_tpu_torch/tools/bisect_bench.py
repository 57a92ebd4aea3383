"""Bisect the SpAtten engine's step cost at a bench point (port of
``tools/bisect_bench.py``): the dense baseline, the full engine, then
head pruning, requant and V pruning switched off one after another, each
timed by ``bench.time_decode`` on int8 weights.

    CACHE=4096 BATCH=16 STEPS=32 python -m spatten_tpu_torch.tools.bisect_bench
"""

from __future__ import annotations

import dataclasses
import os

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.tools import bench


def ladder(cfg_sp) -> list:
    """(name, config) of the rows after "dense" and "spatten full", in the
    JAX tool's order."""
    cfg = dataclasses.replace(
        cfg_sp, pruning=dataclasses.replace(
            cfg_sp.pruning, enable_head_pruning=False, head_keep=0,
            head_update_interval=0))
    cfg2 = dataclasses.replace(
        cfg_sp, quant=dataclasses.replace(cfg_sp.quant,
                                          enable_requant=False))
    cfg3 = dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, enable_requant=False))
    cfg4 = dataclasses.replace(
        cfg3, pruning=dataclasses.replace(cfg3.pruning,
                                          enable_v_pruning=False))
    return [("spatten no-headprune", cfg), ("spatten no-requant", cfg2),
            ("spatten no-hp no-rq", cfg3),
            ("spatten no-hp no-rq no-vp", cfg4)]


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cache = int(os.environ.get("CACHE", 4096))
    batch = int(os.environ.get("BATCH", 16))
    steps = int(os.environ.get("STEPS", 32))
    out = {}

    def run(name, cfg, params):
        tps, _ = bench.time_decode(cfg, params, steps, device=dev)
        out[name] = tps
        bench.log(f"{name}: {tps:.1f} tok/s")

    params = bench.bench_params(dev)

    run("dense", bench.build_cfg(False, cache, batch), params)
    cfg_sp = bench.build_cfg(True, cache, batch)
    thr = bench.calibrate_requant(cfg_sp, params, device=dev)
    bench.log(f"threshold {thr:.3e}")
    cfg_sp = dataclasses.replace(
        cfg_sp, quant=dataclasses.replace(cfg_sp.quant,
                                          requant_threshold=thr))
    run("spatten full", cfg_sp, params)
    for name, cfg in ladder(cfg_sp):
        run(name, cfg, params)
    return out


if __name__ == "__main__":
    main()
