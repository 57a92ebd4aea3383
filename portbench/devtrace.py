"""Reading a ``torch.profiler`` Chrome trace of the profiled stretch:
the device's kernels, its busy time, and what the host was doing in each
gap the device sat idle."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
STRETCH = "portbench.profiled"


def load(path: str) -> dict:
    """The trace's device ops, host ops and the stretch's span (µs)."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    dev, host, stretch = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            dev.append((ts, ts + dur, e["name"]))
        elif cat in HOST_CATS:
            if e["name"] == STRETCH:
                stretch = (ts, ts + dur)
            else:
                host.append((ts, ts + dur, e["name"]))
    if stretch is None:
        raise ValueError("the trace holds no profiled stretch")
    dev.sort()
    host.sort()
    return {"device": dev, "host": host, "stretch": stretch}


def in_stretch(tr: dict) -> list:
    a, b = tr["stretch"]
    return [(max(s, a), min(e, b), n) for s, e, n in tr["device"]
            if e > a and s < b]


def busy_intervals(ops: list) -> list:
    """The union of the ops' intervals, merged, in order."""
    merged: list[list[float]] = []
    for s, e, _ in sorted(ops):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def kernel_time(ops: list, needle: str) -> tuple[float, int]:
    """(seconds, count) of the ops whose name contains ``needle``."""
    t, n = 0.0, 0
    for s, e, name in ops:
        if needle in name:
            t += e - s
            n += 1
    return t * 1e-6, n


def top_ops(ops: list, k: int = 10) -> list:
    """The ``k`` device ops that took most time: [[name, seconds], ...]."""
    by = defaultdict(float)
    for s, e, name in ops:
        by[name] += e - s
    return [[n, t * 1e-6] for n, t in
            sorted(by.items(), key=lambda x: -x[1])[:k]]


def idle_gaps(tr: dict, busy: list, k: int = 10) -> list:
    """The device's idle gaps in the stretch, summed by the innermost host
    op running at each gap's middle: [[host op, seconds], ...], largest
    first."""
    a, b = tr["stretch"]
    edges = [a] + [x for iv in busy for x in iv] + [b]
    host = tr["host"]
    starts = [h[0] for h in host]
    by = defaultdict(float)
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        name = "host outside any op"
        j = bisect.bisect_right(starts, mid) - 1
        for jj in range(j, max(-1, j - 4000), -1):
            if host[jj][1] >= mid:
                name = host[jj][2]
                break
        by[name] += g1 - g0
    return [[n, t * 1e-6] for n, t in
            sorted(by.items(), key=lambda x: -x[1])[:k]]
