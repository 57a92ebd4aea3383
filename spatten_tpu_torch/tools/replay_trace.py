"""Replay a workload trace through the roofline cost model (port of
``tools/replay_trace.py``).

Feed a per-(iteration, layer, head) workload CSV (``engine/trace.py``'s,
or the JAX package's: the 17 columns are the same) and get the modeled
cost: bytes, operations, seconds, tokens/s, and the DRAM-access
reduction against a dense fp16 run of the same workload.

    python -m spatten_tpu_torch.tools.replay_trace <trace.csv>
        [--hbm-gbps G] [--peak-tflops T] [--step-overhead-us U]
        [--weight-bytes-per-step N] [--json out.json]

The arguments and the JSON are the JAX tool's.  The defaults come from
``perf/cost_model.H100_SXM`` (one NVIDIA H100 SXM card), not from the JAX
tool's, which are a TPU's; a caller that passes every flag gets the JAX
tool's numbers.  The script prices a trace and touches no device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from spatten_tpu_torch.engine.trace import read_csv
from spatten_tpu_torch.perf import H100_SXM, dense_bytes, estimate_cost


def replay(path: str, hw=H100_SXM) -> dict:
    """The JAX tool's JSON for the trace at ``path`` priced at ``hw``."""
    rows = read_csv(path)
    res = estimate_cost(rows, hw)
    dense = dense_bytes(rows)
    return {
        "trace": path,
        "rows": len(rows),
        "iterations": res.iterations,
        "total_bytes": res.total_bytes,
        "total_flops": res.total_flops,
        "modeled_seconds": res.total_seconds,
        "modeled_tokens_per_s": res.tokens_per_s,
        "dense_fp16_bytes": dense,
        "dram_access_reduction": (dense / res.total_bytes
                                  if res.total_bytes else 0.0),
        "hw": dataclasses.asdict(hw),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trace")
    ap.add_argument("--hbm-gbps", type=float, default=H100_SXM.hbm_gbps)
    ap.add_argument("--peak-tflops", type=float,
                    default=H100_SXM.peak_tflops)
    ap.add_argument("--step-overhead-us", type=float,
                    default=H100_SXM.step_overhead_us)
    ap.add_argument("--weight-bytes-per-step", type=float,
                    default=H100_SXM.weight_bytes_per_step)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    hw = dataclasses.replace(
        H100_SXM, hbm_gbps=args.hbm_gbps, peak_tflops=args.peak_tflops,
        step_overhead_us=args.step_overhead_us,
        weight_bytes_per_step=args.weight_bytes_per_step)
    out = replay(args.trace, hw)
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(out, fh, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
