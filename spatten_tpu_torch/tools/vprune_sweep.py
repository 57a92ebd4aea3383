"""Where local V pruning pays (port of ``tools/vprune_sweep.py``): sweep
``v_keep_ratio`` x ``v_block`` at a serving capacity and time the decode
step with V pruning on against off (everything else fixed), each row
``bench.time_decode`` on int8 weights.  Prints a markdown table of
ms/step and the net effect per point.

    python -m spatten_tpu_torch.tools.vprune_sweep [cap] [batch]

(default 16384 x 32; ``SPATTEN_BENCH_STEPS``, default 64, steps a window)
"""

from __future__ import annotations

import dataclasses
import os
import sys

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.tools import bench


def main(argv=None, device="cuda") -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device(device)
    cap = int(argv[0]) if len(argv) > 0 else 16384
    batch = int(argv[1]) if len(argv) > 1 else 32
    steps = int(os.environ.get("SPATTEN_BENCH_STEPS", 64))

    params = bench.bench_params(dev)

    def run(v_on, v_keep_ratio=0.25, v_block=None):
        cfg = bench.build_cfg(True, cap, batch)
        pr = dataclasses.replace(
            cfg.pruning, enable_v_pruning=v_on,
            v_keep_ratio=v_keep_ratio,
            v_block_size=v_block or cfg.pruning.v_block_size)
        cfg = dataclasses.replace(cfg, pruning=pr)
        tps, st = bench.time_decode(cfg, params, steps, device=dev)
        del st
        return 1e3 * batch / tps      # ms/step

    base = run(False)
    rows = [("off", None, base)]
    print(f"cap {cap} x b {batch}: V-prune OFF = {base:.3f} ms/step\n")
    print("| v_keep_ratio | v_block | ms/step | net vs off (ms) |")
    print("|---|---|---|---|")
    for ratio in (0.15, 0.25, 0.35, 0.5):
        for vb in (cap // 256, cap // 128, cap // 64):
            if cap % vb:
                continue
            ms = run(True, ratio, vb)
            rows.append((ratio, vb, ms))
            print(f"| {ratio} | {vb} | {ms:.3f} | {base - ms:+.3f} |",
                  flush=True)
    return rows


if __name__ == "__main__":
    main()
