"""Feature-ablation timing of the decode step at a bench point (port of
``tools/profile_fused.py``).

Each SpAtten stage is switched off in turn on top of the full engine;
the difference from the full pipeline prices that stage.  Every row is
``bench.time_decode`` (the bench's own window timer), so the numbers
compare with ``spatten_tpu_torch.tools.bench``'s.  Weights are
``init_params`` from seed 0 in bf16 (not quantized, as in the JAX tool).

    SPATTEN_BENCH_CACHE=4096 SPATTEN_BENCH_BATCH=16 SPATTEN_BENCH_STEPS=16 \\
        python -m spatten_tpu_torch.tools.profile_fused
"""

from __future__ import annotations

import dataclasses
import os

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.tools import bench


def variants(cfg_sp, cfg_dn) -> dict:
    """The JAX tool's six rows, in its order: name -> config."""
    def pruning(**kw):
        return dataclasses.replace(
            cfg_sp, pruning=dataclasses.replace(cfg_sp.pruning, **kw))

    def quant(**kw):
        return dataclasses.replace(
            cfg_sp, quant=dataclasses.replace(cfg_sp.quant, **kw))

    return {
        "dense (honest baseline)": cfg_dn,
        "spatten FULL": cfg_sp,
        "  - token pruning (DENSE lengths)": pruning(
            enable_token_pruning=False),
        "  - requant (msb only)": quant(enable_requant=False),
        "  - v-prune (full V fetch)": pruning(enable_v_pruning=False),
        "  - quant (int8 K fetch)": quant(enabled=False,
                                          enable_requant=False),
    }


def main(device="cuda") -> dict:
    dev = resolve_device(device)
    cache = int(os.environ.get("SPATTEN_BENCH_CACHE", 4096))
    batch = int(os.environ.get("SPATTEN_BENCH_BATCH", 16))
    steps = int(os.environ.get("SPATTEN_BENCH_STEPS", 16))

    cfg_sp = bench.build_cfg(True, cache, batch)
    cfg_dn = bench.build_cfg(False, cache, batch)
    params = transformer.init_params(cfg_sp.model, 0, device=dev)

    thr = bench.calibrate_requant(cfg_sp, params, device=dev)
    cfg_sp = dataclasses.replace(
        cfg_sp, quant=dataclasses.replace(cfg_sp.quant,
                                          requant_threshold=thr))

    results = {}
    for name, cfg in variants(cfg_sp, cfg_dn).items():
        cfg = cfg.validate()
        tps, _state = bench.time_decode(cfg, params, steps, device=dev)
        del _state
        results[name] = cfg.engine.max_batch_size * 1e3 / tps
        print(f"{name:<44s} {results[name]:8.2f} ms/step", flush=True)

    full = results["spatten FULL"]
    print("\nstage cost (full - ablated):")
    for name, ms in results.items():
        if name.startswith("  -"):
            print(f"{name[4:]:<40s} {full - ms:+8.2f} ms", flush=True)
    return results


if __name__ == "__main__":
    main()
