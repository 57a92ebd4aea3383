"""The program's own spans over a traced run of a cell: what each server
tick's host time goes to, what it waits on, and how many prompt rows an
admission's prefill chunk carries.

    python3 -m portbench.program_trace --workload <cell> --seed <n> \\
        --seconds <s>

runs the cell as ``python3 -m portbench.run ... --trace 1`` does (and
prints that result line), with the port's tracer
(``spatten_tpu_torch.utils.profiling.tracer``) on from the start, then
prints one more JSON line: the numbers below, the split of the ticks,
the sync sites, each span name's time, the profiled stretch's idle gaps
under the innermost host range however long it is
(``idle_gaps_nested``) and the tracer's own cost on this host.
``harness.run`` hands its observations (the window, its ticks and which
of them were profiled) to ``window_stats`` once the window has closed,
and the stretch's trace to ``devtrace.idle_gaps``, and this module takes
them there.  A traced run turns the tracer on itself from the warm-up
and keeps its spans as ``obs.program``: the readers
``metrics/<number>.py`` read each number below from them, and this
module reads the same spans, so its numbers are the result line's.

The numbers, each ``fn(obs, spans)`` over the tracer's drained spans and
the harness's observations; a window tick is matched to its
``server.tick`` span by time.  "Outside the stretch" leaves out the
profiled ticks (the profiler slows them); "in the stretch" keeps only
those, the ticks whose wrapped calls do not synchronise before and after
(elsewhere the wrappers drain the device, so the program's own reads
find it idle).  Outside the stretch the wrappers' own synchronisations
(``obs.rec.drains``) wait for the device inside the program's spans:
those around ``prefill_chunk`` inside ``server.admission``, those around
``maybe_prune`` inside ``engine.decode`` and ``engine.prefill``; those
around ``decode_step`` fall in a tick's own time, outside its children.
The issue numbers leave them out with the ``sync.*`` spans.

- ``server.issue_ms``: host ms a tick in ``server.tick``'s child spans,
  their ``sync.*`` spans and the wrappers' drains left out: the host's
  own work (Python, allocation, launches); outside the stretch.
- ``server.sync_wait_ms``: host ms a tick in ``sync.*`` spans; in the
  stretch.
- ``server.syncs_per_tick``: ``sync.*`` spans a tick; every window tick.
- ``server.prefill_rows``: mean ``rows`` of the ``engine.prefill`` spans
  under ``server.admission``; every window tick.
- ``engine.decode_issue_ms``: host ms an ``engine.decode`` span, its
  ``sync.*`` spans and the wrappers' drains left out; outside the
  stretch.
- ``k1.host_us``: host µs a ``k1.launch`` span (K1's operand checks,
  allocations and ctypes call); outside the stretch.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import sys
import time
from collections import defaultdict

TICK = "server.tick"
SYNC = "sync."


def tick_trees(obs, spans) -> list:
    """The window's ticks as (profiled, tick index, [indices of the spans
    under it]), from the tracer's ``server.tick`` spans matched by time to
    the harness's ticks ``obs.first_tick`` .. ``obs.last_tick``."""
    rec = obs.rec
    starts = rec.tick_start
    top = [-1] * len(spans)           # each span's server.tick ancestor
    under: dict = defaultdict(list)
    for i, s in enumerate(spans):
        if s.name == TICK and s.parent < 0:
            top[i] = i
        elif s.parent >= 0:
            top[i] = top[s.parent]
            if top[i] >= 0:
                under[top[i]].append(i)
    out = []
    for i, s in enumerate(spans):
        if top[i] != i or s.t1 is None:
            continue
        t0, t1 = s.t0 * 1e-9, s.t1 * 1e-9
        k = bisect.bisect_right(starts, t0) - 1
        if (k < obs.first_tick or k >= obs.last_tick
                or t1 > rec.tick_end[k]):
            continue
        out.append((bool(rec.tick_info[k]["profiled"]), i, under[i]))
    return out


def _sync_ms(spans, idx) -> float:
    return sum(spans[j].ms for j in idx if spans[j].name.startswith(SYNC))


def _drain_ms(obs, spans, idx) -> float:
    """Host ms of the wrappers' synchronisations (``obs.rec.drains``)
    that lie inside the spans ``idx``, none of which holds another."""
    drains = getattr(obs.rec, "drains", [])
    starts = [d0 for d0, _ in drains]
    total = 0.0
    for j in idx:
        t0, t1 = spans[j].t0 * 1e-9, spans[j].t1 * 1e-9
        k = bisect.bisect_left(starts, t0)
        while k < len(drains) and drains[k][1] <= t1:
            total += drains[k][1] - drains[k][0]
            k += 1
    return 1e3 * total


def _descendants(spans, i: int, under: list) -> list:
    """The spans under span ``i`` among ``under`` (a tick's spans, in
    the order they opened)."""
    inside, out = {i}, []
    for j in under:
        if spans[j].parent in inside:
            inside.add(j)
            out.append(j)
    return out


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def issue_ms(obs, spans):
    per_tick = []
    for profiled, i, under in tick_trees(obs, spans):
        if profiled:
            continue
        kids = [j for j in under if spans[j].parent == i]
        per_tick.append(sum(spans[j].ms for j in kids)
                        - _sync_ms(spans, under)
                        - _drain_ms(obs, spans, kids))
    return _mean(per_tick)


def sync_wait_ms(obs, spans):
    return _mean([_sync_ms(spans, under)
                  for profiled, _, under in tick_trees(obs, spans)
                  if profiled])


def syncs_per_tick(obs, spans):
    return _mean([sum(1 for j in under if spans[j].name.startswith(SYNC))
                  for _, _, under in tick_trees(obs, spans)])


def prefill_rows(obs, spans):
    return _mean([spans[j].attrs["rows"]
                  for _, _, under in tick_trees(obs, spans) for j in under
                  if spans[j].name == "engine.prefill"
                  and spans[spans[j].parent].name == "server.admission"])


def decode_issue_ms(obs, spans):
    out = []
    for profiled, _, under in tick_trees(obs, spans):
        if profiled:
            continue
        for j in under:
            if spans[j].name == "engine.decode":
                out.append(spans[j].ms
                           - _sync_ms(spans, _descendants(spans, j, under))
                           - _drain_ms(obs, spans, [j]))
    return _mean(out)


def k1_host_us(obs, spans):
    return _mean([1e3 * spans[j].ms
                  for profiled, _, under in tick_trees(obs, spans)
                  if not profiled for j in under
                  if spans[j].name == "k1.launch"])


NUMBERS = {
    "server.issue_ms": issue_ms,
    "server.sync_wait_ms": sync_wait_ms,
    "server.syncs_per_tick": syncs_per_tick,
    "server.prefill_rows": prefill_rows,
    "engine.decode_issue_ms": decode_issue_ms,
    "k1.host_us": k1_host_us,
}


def tick_split(obs, spans) -> dict:
    """Per tick, in and outside the stretch: the tick's span, its
    children's, the host's own work, the sync waits and the wrappers'
    drains in them, the tick's own time (the wrappers' and the server's
    code between children), the harness's time between ticks, each child
    and each sync site (ms a tick, and spans a tick), and the children's
    share of the tick."""
    ticks = tick_trees(obs, spans)
    order = sorted(i for _, i, _ in ticks)
    after = dict(zip(order, order[1:]))       # each tick's next tick
    out = {}
    for where, want in (("outside", False), ("stretch", True)):
        sel = [(i, u) for p, i, u in ticks if p == want]
        if not sel:
            continue
        n = len(sel)
        tick = sum(spans[i].ms for i, _ in sel)
        kids = sum(spans[j].ms for i, u in sel for j in u
                   if spans[j].parent == i)
        syncs = sum(_sync_ms(spans, u) for _, u in sel)
        drains = sum(_drain_ms(obs, spans, [j for j in u
                                            if spans[j].parent == i])
                     for i, u in sel)
        by_child, by_sync = defaultdict(float), defaultdict(float)
        n_sync = defaultdict(int)
        for i, u in sel:
            for j in u:
                s = spans[j]
                if s.parent == i:
                    by_child[s.name] += s.ms
                if s.name.startswith(SYNC):
                    by_sync[s.name] += s.ms
                    n_sync[s.name] += 1
        # the harness's own time between one tick's span and the next's
        between = [(spans[after[i]].t0 - spans[i].t1) * 1e-6
                   for i, _ in sel if i in after]
        out[where] = {
            "ticks": n, "tick_ms": tick / n, "children_ms": kids / n,
            "issue_ms": (kids - syncs - drains) / n, "sync_ms": syncs / n,
            "drain_ms": drains / n,
            "self_ms": (tick - kids) / n,
            "between_ms": _mean(between),
            "children_share": kids / tick if tick else None,
            "children": {k: v / n for k, v in sorted(by_child.items())},
            "syncs": {k: [n_sync[k] / n, v / n]
                      for k, v in sorted(by_sync.items())},
            "spans_per_tick": sum(len(u) + 1 for _, u in sel) / n}
    return out


def by_name(obs, spans) -> dict:
    """Per window tick outside the stretch, for each span name: spans,
    host ms, and self ms (the span's time less its children's).  The
    wrappers' drains sit in the times of the spans around a wrapped call
    (``server.admission``, ``engine.decode``, ``engine.prefill``)."""
    out: dict = {}
    ticks = [(i, u) for p, i, u in tick_trees(obs, spans) if not p]
    for i, u in ticks:
        for j in [i] + u:
            s = spans[j]
            n, ms, own = out.get(s.name, (0, 0.0, 0.0))
            out[s.name] = (n + 1, ms + s.ms, own + s.ms)
            if s.parent >= 0:
                p = spans[s.parent].name
                n, ms, own = out[p]
                out[p] = (n, ms, own - s.ms)
    k = max(len(ticks), 1)
    return {name: [n / k, ms / k, own / k]
            for name, (n, ms, own) in sorted(out.items())}


def idle_gaps_nested(tr: dict, busy: list, k: int | None = 10) -> list:
    """``devtrace.idle_gaps``'s sums (each idle gap of the stretch under
    the innermost host range running at its middle) with no limit on how
    far back that range starts: a gap inside a program span that holds
    thousands of host ops (an admission's prefill chunk) is put under the
    span, where ``devtrace`` looks back 4,000 ops and then reads "host
    outside any op".  Host ranges of one thread nest, so a stack of the
    ranges open at each gap's middle finds it.  ``k`` None: every
    name."""
    a, b = tr["stretch"]
    edges = [a] + [x for iv in busy for x in iv] + [b]
    host = tr["host"]
    stack: list = []
    j = 0
    by: dict = defaultdict(float)
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        by[stack[-1][2] if stack else "host outside any op"] += g1 - g0
    return [[n, t * 1e-6] for n, t in
            sorted(by.items(), key=lambda x: -x[1])[:k]]


def tracer_cost(n: int = 20000) -> dict:
    """Host µs for a span site with the tracer on (no profiler
    recording), on with a profiler recording the host (the span then
    also opens a profiler range, as in the stretch) and off, on this
    host: the best of 5 loops of ``n``."""
    import torch
    from spatten_tpu_torch.utils.profiling import tracer
    was = tracer.on
    best = {}
    try:
        for key, on in (("on_us", True), ("profiled_us", True),
                        ("off_us", False)):
            tracer.on = on
            t_best = float("inf")
            for _ in range(5):
                prof = (torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU])
                    if key == "profiled_us" else contextlib.nullcontext())
                with prof:
                    t0 = time.perf_counter()
                    for _ in range(n):
                        with tracer.span("cost"):
                            pass
                    t_best = min(t_best, time.perf_counter() - t0)
                tracer.drain()
            best[key] = 1e6 * t_best / n
    finally:
        tracer.on = was
    return best


def report(obs, spans, trace=None) -> dict:
    """Everything this module reads; ``trace``: the profiled stretch's
    (trace, busy intervals) as ``devtrace.idle_gaps`` took them."""
    numbers = {name: fn(obs, spans) for name, fn in NUMBERS.items()}
    prunes = [s.attrs.get("layers", 0) for s in spans
              if s.name == "engine.prune"]
    chunks: dict = defaultdict(list)       # request id -> its chunks' tokens
    for _, _, under in tick_trees(obs, spans):
        for j in under:
            s = spans[j]
            if (s.name == "engine.prefill"
                    and spans[s.parent].name == "server.admission"):
                chunks[spans[s.parent].attrs["request"]].append(
                    s.attrs["tokens"])
    out = {"numbers": numbers, "split": tick_split(obs, spans),
           "by_name": by_name(obs, spans),
           "prefill_tokens": _mean([t for c in chunks.values() for t in c]),
           "chunks_per_admission": _mean([len(c) for c in chunks.values()]),
           "compacting_prunes": sum(1 for x in prunes if x),
           "spans": len(spans), "cost": tracer_cost()}
    if trace is not None:
        gaps = idle_gaps_nested(*trace, k=None)
        out["idle_gaps_nested"] = gaps[:10]
        out["outside_any_op_s"] = dict(gaps).get("host outside any op", 0.0)
    return out


@contextlib.contextmanager
def taken():
    """While open: the tracer on, and what ``harness.run`` hands on kept
    in the yielded dict, ``obs`` (its observations, at
    ``window_stats``) and ``trace`` (the profiled stretch's trace and
    busy intervals, at ``devtrace.idle_gaps``).  On exit the tracer is
    off and its spans are under ``spans``: those a traced run kept as
    ``obs.program``, else those the tracer still holds."""
    from portbench import devtrace, harness
    from spatten_tpu_torch.utils.profiling import tracer

    seen: dict = {}
    window_stats, idle_gaps = harness.window_stats, devtrace.idle_gaps

    def took_obs(obs):
        seen["obs"] = obs
        return window_stats(obs)

    def took_trace(tr, busy, *a, **kw):
        seen["trace"] = (tr, busy)
        return idle_gaps(tr, busy, *a, **kw)

    harness.window_stats, devtrace.idle_gaps = took_obs, took_trace
    tracer.enable()
    try:
        yield seen
    finally:
        tracer.disable()
        harness.window_stats, devtrace.idle_gaps = window_stats, idle_gaps
        held = tracer.drain()
        program = getattr(seen.get("obs"), "program", None)
        seen["spans"] = held if program is None else program


def main(argv=None) -> int:
    from portbench import run

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" not in argv:
        argv += ["--trace", "1"]
    with taken() as seen:
        rc = run.main(argv)
    if rc or "obs" not in seen:
        return rc or 1
    print(json.dumps(report(seen["obs"], seen["spans"],
                            seen.get("trace"))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
