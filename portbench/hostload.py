"""The host's side of a window: the counters that tell a slow host from a
slow program.  The ticks are host-bound, so a window's rate follows the
core that runs the Python thread: these numbers, logged beside each run,
show whether a slow run had its thread off the CPU (steal, involuntary
switches, the thread's CPU share) or on it at a lower pace.  The machine's
counters are Linux's; elsewhere they read nothing."""

from __future__ import annotations

import gc
import resource
import time


def sample() -> dict:
    """The counters now: the machine's CPU time by state (``/proc/stat``),
    this thread's CPU seconds, the process's involuntary context switches
    and the garbage collector's runs."""
    try:
        with open("/proc/stat") as f:
            cpu = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        cpu = []
    return {"cpu": cpu, "thread": time.thread_time(),
            "wall": time.perf_counter(),
            "switches": resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw,
            "gc": sum(s["collections"] for s in gc.get_stats())}


def report(a: dict, b: dict) -> str:
    """One line on what the host did between two samples."""
    wall = max(b["wall"] - a["wall"], 1e-9)
    ran = 100 * (b["thread"] - a["thread"]) / wall
    line = (f"host: the main thread ran {ran:.1f}% of the window, "
            f"{b['switches'] - a['switches']} involuntary switches, "
            f"{b['gc'] - a['gc']} gc runs")
    d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
    if len(d) > 7 and sum(d) > 0:
        total = sum(d)
        busy = 100 * (total - d[3] - d[4]) / total
        line += f"; the machine busy {busy:.1f}%, steal " \
                f"{100 * d[7] / total:.2f}%"
    return line
