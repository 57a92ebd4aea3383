"""Read the correctness numbers of many seeds in one process, to set a
cell's limits (``limits/<cell>.json``): the program as the cell runs it
(with ``--fp8`` also the float8 reference and the altered-token stand-in
read at the same positions), and the program serving from weight-only
int8 copies of the weights (``--control-seeds``).  The benchmark's runs
never run these.

    python3 -m portbench.calibrate --workload <name> --seconds <s> \\
        --seeds 1,2,3 [--fp8] [--control-seeds 4,5,6]

prints one JSON line a run (the seed, the control, ``correct``, every
reading, the end-to-end metrics); the last line gathers the compared
numbers and each run's ``correct``, the stand-ins' too (each held to
the cell's limits as the program is).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from portbench import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fp8", action="store_true",
                    help="also read the fp8 and altered-token stand-ins on "
                         "the program's seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    runs = [(int(s), "fp8" if args.fp8 else None)
            for s in args.seeds.split(",") if s]
    runs += [(int(s), "int8") for s in args.control_seeds.split(",") if s]
    summary: dict = {}
    for seed, control in runs:
        t0 = time.perf_counter()
        r = harness.run(args.workload, seed, args.seconds, False,
                        t_start=t0, device="cuda:0", control=control,
                        keep_gaps=True)
        line = {"seed": seed, "control": control,
                "compared": {n: x["value"] for n, x in r["compared"].items()},
                "metrics": {n: x["value"] for n, x in r["metrics"].items()},
                "peak": r["device"]["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0,
                "readings": r["readings"]}
        line["correct"] = r["correct"]
        print(json.dumps(line), flush=True)
        for n, v in line["compared"].items():
            summary.setdefault(str(control), {}).setdefault(n, []).append(v)
        summary.setdefault(str(control), {}).setdefault(
            "correct", []).append(r["correct"])
        for name, v in r["readings"].get("verdicts", {}).items():
            summary.setdefault(name, {}).setdefault("correct", []).append(
                v["correct"])
        del r
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
