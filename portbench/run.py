"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository's root, on a machine with as many CUDA cards as the
cell asks for.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` also ``breakdown``, and last ``compared``: each number the
correctness check compared, with its limit); the last lines of standard
error repeat the compared numbers.  Without the cards, or if the JAX
package or JAX itself was loaded, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spatten_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that must not be loaded, each
    name compared whole (``spatten_tpu_torch`` is not ``spatten_tpu``)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    # one process, few threads: the host path is one thread, and the
    # CPU pools' workers only compete with it for the cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"

    import torch
    torch.set_num_threads(1)
    from portbench import harness, manifest

    chips = manifest.cell(manifest.load(root), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), t_start=T_START, device="cuda:0")
    bad = loaded_forbidden()
    if bad:
        print(f"portbench: loaded {bad} in the measuring process",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
