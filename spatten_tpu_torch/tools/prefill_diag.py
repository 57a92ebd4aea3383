"""The prefill gap against dense, stage by stage (port of
``tools/prefill_diag.py``): chunked prefill throughput at one prompt
length for the dense baseline, the full SpAtten engine, and the engine
with V pruning and then head pruning off (``bench.measure_prefill`` on
int8 weights).  Prints a markdown table.

    python -m spatten_tpu_torch.tools.prefill_diag [prompt_len] [cap] [batch]

(default 2048, 16384, 32)
"""

from __future__ import annotations

import dataclasses
import sys

from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.tools import bench


def main(argv=None, device="cuda") -> list:
    argv = sys.argv[1:] if argv is None else list(argv)
    dev = resolve_device(device)
    plen = int(argv[0]) if len(argv) > 0 else 2048
    cap = int(argv[1]) if len(argv) > 1 else 16384
    batch = int(argv[2]) if len(argv) > 2 else 32

    params = bench.bench_params(dev)
    rows = []

    def run(label, spatten, **pr_over):
        cfg = bench.build_cfg(spatten, cap, batch)
        if pr_over:
            cfg = dataclasses.replace(
                cfg, pruning=dataclasses.replace(cfg.pruning, **pr_over))
        tps, ttft = bench.measure_prefill(cfg, params, plen, device=dev)
        rows.append((label, tps, ttft))
        print(f"| {label} | {tps:.0f} | {ttft:.0f} |", flush=True)

    print(f"prompt {plen}, cap {cap}, batch {batch}\n")
    print("| variant | tok/s | TTFT ms |")
    print("|---|---|---|")
    run("dense", False)
    run("spatten full", True)
    run("spatten, V-prune off", True, enable_v_pruning=False)
    run("spatten, V+head off", True, enable_v_pruning=False,
        enable_head_pruning=False)
    return rows


if __name__ == "__main__":
    main()
