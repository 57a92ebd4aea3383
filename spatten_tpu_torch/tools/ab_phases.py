"""Run ``chip_smoke.py`` phases of two checkouts in one call on the card.

Builds both checkouts' kernels at once (each into its own
``build/cuda/``), then runs the named phases from BEFORE, AFTER, AFTER,
BEFORE, each run in a process of its own, so that both versions meet the
same card and its drift shows as the gap between a version's two runs.
Every phase must take the device as its one argument.  Run on a machine
with one card and nvcc, with BEFORE unpacked under a git-ignored directory
of the repository (``git archive``)::

    python -m spatten_tpu_torch.tools.ab_phases BEFORE AFTER \\
        phase_k1_device_scores phase_k1_long_windows

Prints each run's log (the phases' timing lines), headed by the tree.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

BUILD = ("from spatten_tpu_torch import kernels; "
         "print(f'built in {kernels.build_all()[0]:.1f} s')")
RUN = ("import sys, torch, chip_smoke as cs; "
       "torch.backends.cuda.matmul.allow_tf32 = False; "
       "dev = torch.device('cuda', 0); "
       "[getattr(cs, name)(dev) for name in sys.argv[1:]]")


def main(argv: list[str]) -> int:
    if len(argv) < 3:
        print(__doc__, file=sys.stderr)
        return 2
    trees = [Path(t).resolve() for t in argv[:2]]
    phases = argv[2:]
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t)
              for t in trees]
    if any(p.wait() != 0 for p in builds):
        return 1
    for tree in (trees[0], trees[1], trees[1], trees[0]):
        print(f"=== {tree}", flush=True)
        if subprocess.run([sys.executable, "-c", RUN, *phases],
                          cwd=tree).returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
