"""One run of one cell: drive the port's continuous-batching server
(``spatten_tpu_torch.engine.server.SpAttenServer``: ``submit`` and
``step``) for a window of seconds, judge what it served against the plain
reference, and read the cell's metrics.

Set-up: build or load the CUDA kernels, make the weights from the seed,
stage each client's first request (``engine.generate.prefill`` over
groups of equal length, written into free slots with
``engine.state.write_slot``), run the mix's warm-up ticks.  Window:
``server.step`` until the seconds are up; a closed-loop client submits
its next request after the tick that finished its last.  A token counts
as emitted at the end of the tick that appended it.  Between ticks the
harness reads only what the server hands out (requests, tokens) and keeps
references to the state's functional fields (the head mask); it copies a
judged session's cache on the device at the tick planned for it, and
reads the lengths and importance for the head-mask check until that check
has its update.  After the window: the device's peak memory, then the
program's state is freed and the reference replays a seed-drawn sample of
the served requests.

Everything about the model (the port's configuration, the weights, the
plain reference and the model's operation and byte counts) comes from
the model path the configuration names (``manifest.path``;
``paths/__init__.py``).

With ``trace`` the harness also wraps the program's calls from outside
(synchronised host clocks around ``server.step``, ``generate.
prefill_chunk``, ``generate.decode_step`` and ``generate.maybe_prune``)
and runs ``torch.profiler`` over a stretch of ``PROFILED_TICKS`` ticks
(one that holds a prune where the cell prunes); inside that stretch the
wrappers neither synchronise nor read the device, and keep references
that are read once it has closed; outside it they note each of their
synchronisations (``Record.drains``).  It also turns the program's own
tracer on (``spatten_tpu_torch.utils.profiling.tracer``) from the
warm-up to the run's last tick and hands its spans to the readers as
``obs.program``; an untraced run leaves it off.  Inside the stretch each
program span is also a profiler range, so the idle gaps of ``breakdown``
fall under the innermost program span that was open.  The per-layer
readers take their numbers from those.
"""

from __future__ import annotations

import gc
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from portbench import devtrace, hostload, manifest
from portbench.traffic import generate as traffic_gen

import spatten_tpu_torch.engine.generate as gen
from spatten_tpu_torch import kernels
from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.engine import server as server_mod
from spatten_tpu_torch.engine.state import init_state, write_slot
from spatten_tpu_torch.models import weight_quant
from spatten_tpu_torch.pruning import compact as compact_mod
from spatten_tpu_torch.pruning.token_pruning import layer_capacities
from spatten_tpu_torch.utils.profiling import tracer

PROFILED_TICKS = 24
K1_KERNEL = "fused_decode_kernel"
K2_KERNEL = "compact_gather_kernel"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------ the program
def _row(st, i: int):
    """Batch row ``i`` of a decode state, as a batch-1 view."""
    def sl(x):
        return None if x is None else x[:, i:i + 1]
    cache = type(st.cache)(k=type(st.cache.k)(*(sl(x) for x in st.cache.k)),
                           v=type(st.cache.v)(*(sl(x) for x in st.cache.v)))
    return st._replace(cache=cache, importance=st.importance[:, i:i + 1],
                       lengths=st.lengths[i:i + 1],
                       layer_lengths=st.layer_lengths[:, i:i + 1])


def seat(server, prompt, max_new_tokens: int, slot: int, first: int):
    """Make a request whose prompt is already in arena slot ``slot`` active
    with its first token, as a finished admission leaves it.  The server
    has no entry for this, so this one function writes its bookkeeping
    (``free_slots``, ``_ids``, ``active``).  Returns the Request."""
    server.free_slots.remove(slot)
    req = server_mod.Request(request_id=next(server._ids), prompt=prompt,
                             max_new_tokens=max_new_tokens)
    req.slot, req.next_token = slot, first
    server.active[slot] = req
    return req


def stage(server, params, cfg, reqs, batch: int, dev) -> dict:
    """Prefill ``reqs`` in groups of equal prompt length (at most ``batch``
    a group) and seat each in a free slot with its first token, as an
    admission that has just finished.  Returns {request id: Req}."""
    by_len: dict[int, list] = {}
    for r in reqs:
        by_len.setdefault(len(r.prompt), []).append(r)
    seated = {}
    for length in sorted(by_len):
        group = by_len[length]
        for g0 in range(0, len(group), batch):
            part = group[g0:g0 + batch]
            sub = init_state(cfg, batch=len(part), device=dev)
            ids = torch.from_numpy(np.stack([r.prompt for r in part])).to(dev)
            logits, sub, _, _ = gen.prefill(params, cfg, sub, ids)
            first = torch.argmax(logits, dim=-1).cpu().tolist()
            for i, r in enumerate(part):
                slot = server.free_slots[0]
                server.state = write_slot(server.state, _row(sub, i), slot)
                req = seat(server, r.prompt, r.max_new_tokens, slot,
                           int(first[i]))
                seated[req.request_id] = r
            del sub
    return seated


# -------------------------------------------------------------- recording
@dataclass
class Record:
    """What the run saw: ticks, tokens and the calls it wrapped.  Inside
    the profiled stretch the wrappers store device tensors where they
    would read them; ``settle`` reads them once the stretch has closed."""

    tick: int = 0
    tick_end: list = field(default_factory=list)      # host s, by tick
    tick_start: list = field(default_factory=list)
    token_ticks: dict = field(default_factory=dict)   # req id -> [tick]
    submit_time: dict = field(default_factory=dict)   # req id -> host s
    done_tick: dict = field(default_factory=dict)     # req id -> tick
    requests: dict = field(default_factory=dict)      # req id -> Request
    masks: list = field(default_factory=list)         # [(tick, mask)]
    spans: dict = field(default_factory=dict)         # name -> [(t0,t1,x)]
    trace: bool = False
    profiling: bool = False
    tick_info: list = field(default_factory=list)     # per tick (trace)
    k2_calls: list = field(default_factory=list)
    requants: object = None
    # the wrappers' own synchronisations outside the stretch, (t0, t1)
    # host s in time order: device time that lands inside the program's
    # spans around a wrapped call, for ``program_trace`` to leave out
    drains: list = field(default_factory=list)

    def settle(self) -> None:
        """Read what the wrappers and ticks kept as device tensors."""
        for name, spans in self.spans.items():
            self.spans[name] = [(t0, t1, _host(x)) for t0, t1, x in spans]
        self.k2_calls = [_k2_counts(*c) if isinstance(c, tuple) and
                         len(c) == 3 else c for c in self.k2_calls]
        for info in self.tick_info:
            for key in ("lens", "mask", "requants"):
                if isinstance(info.get(key), torch.Tensor):
                    x = info[key].cpu()
                    info[key] = x.numpy() if key == "lens" else (
                        x.tolist() if key == "requants" else x)


def _host(x):
    """A wrapper's note with its device tensors read."""
    if isinstance(x, torch.Tensor):
        return bool(x.any()) if x.dtype == torch.bool else x.cpu().tolist()
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    return x


def _k2_counts(keep_idx, keep_count, triggered) -> tuple[int, int]:
    """(moved, kept) (token, head) rows of one compaction: a kept row
    moves where its index is not its new slot."""
    kc, trig, idx = keep_count.cpu(), triggered.to(torch.bool).cpu(), \
        keep_idx.cpu()
    moved = kept = 0
    for b in range(idx.shape[0]):
        if trig[b]:
            n = int(kc[b])
            moved += int((idx[b, :, :n] != torch.arange(n)).sum())
            kept += n
    return moved, kept


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Wrapped:
    """The program's functions wrapped from outside for a traced run, put
    back by ``restore``.  Outside the profiled stretch each call is timed
    between two synchronisations; inside it the wrapper only notes the
    call, and what it keeps of the call is read after the stretch."""

    def __init__(self, rec: Record, dev, cfg: SpAttenConfig):
        self.saved = []
        self.rec, self.dev, self.cfg = rec, dev, cfg
        if rec.trace:
            self._patch(gen, "prefill_chunk", self._timed(
                "engine.prefill_chunk", self._prefill_info))
            self._patch(gen, "decode_step", self._timed(
                "engine.decode_step", self._decode_info))
            self._patch(gen, "maybe_prune", self._timed(
                "engine.maybe_prune", self._prune_info))
            self._patch(compact_mod, "gather_compact_rows", self._k2)

    def _patch(self, mod, name, make):
        orig = getattr(mod, name)
        self.saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def restore(self):
        for mod, name, orig in reversed(self.saved):
            setattr(mod, name, orig)

    def _timed(self, name, info):
        rec, dev = self.rec, self.dev

        def wrap(orig):
            def drain():
                d0 = time.perf_counter()
                _sync(dev)
                d1 = time.perf_counter()
                rec.drains.append((d0, d1))
                return d1

            def timed(*a, **kw):
                quiet = rec.profiling
                if not quiet:
                    drain()
                t0 = time.perf_counter()
                with torch.profiler.record_function(name):
                    out = orig(*a, **kw)
                t1 = time.perf_counter() if quiet else drain()
                rec.spans.setdefault(name, []).append(
                    (t0, t1, info(a, kw, out)))
                return out
            return timed
        return wrap

    # each keeps device tensors that no later call changes in place (the
    # program replaces these fields rather than writing into them)
    def _prefill_info(self, a, kw, out):
        state, tokens = a[2], a[3]
        return (int(tokens.shape[1]), state.layer_lengths[:, 0])

    def _decode_info(self, a, kw, out):
        self.rec.requants = out[2].layer_requants
        return None

    def _prune_info(self, a, kw, out):
        return out[1]

    def _k2(self, orig):
        rec = self.rec

        def gather_compact_rows(k_plane, v_plane, keep_idx, lengths,
                                triggered, *, keep_count=None, window=None):
            if rec.profiling:
                rec.k2_calls.append((keep_idx, lengths if keep_count is None
                                     else keep_count, triggered))
            return orig(k_plane, v_plane, keep_idx, lengths, triggered,
                        keep_count=keep_count, window=window)
        return gather_compact_rows


# ---------------------------------------------------------------- the run
class Phases:
    """Logs the seconds each phase of a run took, to standard error."""

    def __init__(self, t0: float):
        self.t = t0

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        log(f"[{name}: {now - self.t:.2f} s]")
        self.t = now


def device_info(dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": 1}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(dev.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
        info["power_limit"] = out.split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "unknown"
    return info


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device="cuda", root: Path = manifest.REPO,
        bench: dict | None = None, bench_dir: Path = manifest.BENCH_DIR,
        control: str | None = None, keep_gaps: bool = False) -> dict:
    """One run of cell ``workload``; returns the result line's object.
    ``control`` (the benchmark's runs never set it; ``calibrate`` does):
    "int8" serves from weight-only int8 copies of the weights (the
    program's own lower-precision path), judged against the same
    reference; "fp8" serves as the cell does and also reads the numbers
    for two stand-ins at the judged positions (``control_readings``).
    ``keep_gaps``: the result also holds the per-row gaps and every
    reading."""
    bench = bench or manifest.load(root)
    cell = manifest.cell(bench, workload)
    c = manifest.config(bench, cell["config"], root)
    spec = traffic_gen.load(cell["traffic"], Path(bench_dir) / "traffic")
    lim = manifest.limits(workload, bench_dir)
    dev = torch.device(device)
    info = device_info(dev)
    log(f"device: {info}")
    phase = Phases(t_start)
    if dev.type == "cuda":
        kernels.build_all()
    phase("kernels")
    path = manifest.path(c, bench_dir)
    cfg = path.program_config(c)
    params = path.make_params(c, seed, dev,
                              getattr(torch, c["engine"]["param_dtype"]))
    if control not in (None, "int8", "fp8"):
        raise ValueError(f"control {control!r}")
    served = params
    if control == "int8":
        # every matrix product's weights int8 with one scale per output
        # channel; the embedding stays a row lookup of the bf16 table
        served = dict(weight_quant.quantize_params(params),
                      embed=params["embed"])
    server = server_mod.SpAttenServer(served, cfg, device=dev)
    traffic = traffic_gen.Traffic(spec, seed, cfg.engine.max_batch_size,
                                  c["vocab_size"])
    phase("weights and arena")
    seated = stage(server, served, cfg, traffic.staged(),
                   spec["stage_batch"], dev)
    phase("staging")
    rec = Record(trace=trace)
    client_of = {rid: r.client for rid, r in seated.items()}
    rec.requests.update({q.request_id: q for q in server.active.values()})
    rec.masks.append((-1, server.state.head_mask))
    wrapped = Wrapped(rec, dev, cfg)
    prof = None
    rungs = token_rungs(cfg)
    probe = HeadMaskProbe(c, rungs)
    snaps: dict = {}
    accepting = True
    try:
        if trace and dev.type == "cuda":
            _warm_profiler(dev)
        if trace:
            tracer.enable()

        def tick():
            rec.tick_start.append(time.perf_counter())
            finished = server.step()
            t = time.perf_counter()
            k = rec.tick
            rec.tick_end.append(t)
            emitted = []
            for req in list(server.active.values()) + finished:
                got = rec.token_ticks.setdefault(req.request_id, [])
                if len(req.generated) > len(got):
                    got.append(k)
                    emitted.append(req.slot)
            for req in finished:
                rec.done_tick[req.request_id] = k
                nxt = (traffic.next_request(client_of[req.request_id])
                       if accepting else None)
                if nxt is not None:
                    rid = server.submit(nxt.prompt, nxt.max_new_tokens)
                    rec.submit_time[rid] = time.perf_counter()
                    rec.requests[rid] = server.pending[-1]
                    client_of[rid] = nxt.client
            # the state's head mask is replaced, never written into
            mask = server.state.head_mask
            if mask is not rec.masks[-1][1]:
                rec.masks.append((k, mask))
            if trace:
                lens = server.state.layer_lengths
                rec.tick_info.append(dict(
                    lens=lens.clone() if rec.profiling else
                    lens.cpu().numpy(),
                    requants=rec.requants, profiled=rec.profiling,
                    slots=emitted, mask=mask if rec.profiling else None))
                rec.requants = None
            rec.tick += 1

        def probed_tick():
            if not rec.profiling:
                probe.before(server)
            tick()
            probe.after(server)

        first_tick = 1 << 60
        for _ in range(spec["warmup_ticks"]):
            probed_tick()
        sessions = {rid for rid, r in seated.items()
                    if r.client < traffic.sessions}
        plan = plan_sessions(server, spec, seed, sessions, rungs, rec.tick)
        _sync(dev)
        gc.collect()
        gc.freeze()
        before = hostload.sample()
        w0 = time.perf_counter()
        phase("warm-up")
        setup_s = w0 - t_start
        first_tick = rec.tick
        prof_done = False
        stretch = None
        while time.perf_counter() - w0 < seconds:
            if trace and not rec.profiling and not prof_done:
                frac = (time.perf_counter() - w0) / seconds
                soon = ticks_to_prune(rec, rungs) <= PROFILED_TICKS // 2
                if frac >= 0.25 and (soon or frac >= 0.5):
                    prof, stretch = _start_profiler(dev), rec.tick
                    rec.profiling = True
            for slot in plan.get(rec.tick, ()):
                snaps[server.active[slot].request_id] = snapshot(server,
                                                                 slot)
            probed_tick()
            if rec.profiling and rec.tick - stretch >= PROFILED_TICKS:
                _stop_profiler(prof, dev)
                rec.profiling, prof_done = False, True
        w1 = rec.tick_end[-1]
        last_tick = rec.tick
        if rec.profiling:
            _stop_profiler(prof, dev)
            rec.profiling = False
        log(hostload.report(before, hostload.sample()))
        gc.unfreeze()
        # no clean head-mask update in the warm-up or the window (where
        # admissions land on most ticks): with no more requests taken,
        # the admissions drain and the next update is clean; these ticks
        # count for nothing else
        accepting = False
        for _ in range(probe.spare_ticks):
            if probe.done:
                break
            probed_tick()
    finally:
        wrapped.restore()
        tracer.disable()
    rec.settle()
    phase(f"window ({last_tick - first_tick} ticks; then "
          f"{rec.tick - last_tick} for the head-mask check)")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    info["memory_peak_bytes"] = int(peak)

    obs = SimpleNamespace(
        config=c, cfg=cfg, cell=cell, spec=spec, rec=rec, seconds=seconds,
        setup_s=setup_s, window_s=w1 - w0, w0=w0, w1=w1,
        first_tick=first_tick, last_tick=last_tick, rungs=rungs,
        sessions=sessions, path=path, counts=path.counts, stretch=None,
        program=tracer.drain() if trace else None)
    obs.knobs = path.reference.Knobs.from_config(c)
    obs.window_spans = lambda name, profiled=False: window_spans(
        obs, name, profiled)
    tokens, gaps, ttfts, attempted = window_stats(obs)
    obs.tokens, obs.gaps, obs.ttfts = tokens, gaps, ttfts

    # the judged sample, then the program's state goes
    rows, mask_table, tallies = sample_rows(obs, snaps, seed, dev)
    mask_probe = probe.got
    del server, served, snaps, probe
    rec.requests.clear()
    rec.masks = []
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    result_device = dict(info)
    breakdown = None
    if trace and prof is not None:
        obs.stretch, breakdown = read_trace(prof, obs)
        phase("trace read")
        result_device["busy_s"] = obs.stretch["busy_s"]
        result_device["window_s"] = obs.stretch["window_s"]

    gaps: list = []
    readings: dict = {}
    compared = judge(c, params, rows, mask_table, mask_probe, lim, dev, gaps,
                     control, readings, tallies, ref_mod=path.reference)
    phase(f"reference ({len(rows)} requests)")
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics_for(bench, workload, kind):
        value = manifest.reader(m["name"], bench_dir)(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    phase("metrics")
    correct = all(x["ok"] for x in compared.values())
    for name, x in compared.items():
        log(f"compared {name}: {x['value']!r} {x['rule']} {x['limit']!r}"
            f" -> {'ok' if x['ok'] else 'FAILED'}")
    out = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics, "device": result_device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if keep_gaps:
        out["gaps"] = [g.tolist() for g in gaps]
        out["readings"] = readings
    out["compared"] = {n: {"value": x["value"], "limit": x["limit"],
                           "rule": x["rule"]} for n, x in compared.items()}
    return out


def token_rungs(cfg: SpAttenConfig) -> list[int]:
    return list(layer_capacities(cfg))


def ticks_to_prune(rec: Record, rungs: list[int]) -> int:
    """Ticks until some slot of some layer reaches its rung (from the
    lengths the last traced tick read), or a large number."""
    if not rec.tick_info:
        return 1 << 30
    lens = rec.tick_info[-1]["lens"]
    left = np.asarray(rungs)[:, None] - lens
    return int(left.min()) + 1


def _warm_profiler(dev) -> None:
    """Start and stop the profiler once in set-up, so the window's
    profiled stretch does not pay CUPTI's first start."""
    x = torch.ones(1024, device=dev)
    with torch.profiler.profile(activities=_activities(dev)):
        (x * 2).sum().item()


def _activities(dev):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _start_profiler(dev):
    prof = torch.profiler.profile(activities=_activities(dev))
    prof.start()
    prof._portbench_span = torch.profiler.record_function(devtrace.STRETCH)
    prof._portbench_span.__enter__()
    return prof


def _stop_profiler(prof, dev) -> None:
    _sync(dev)
    prof._portbench_span.__exit__(None, None, None)
    prof.stop()


def read_trace(prof, obs) -> tuple[dict, dict]:
    """The profiled stretch's device numbers, and the breakdown."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = devtrace.load(path)
    finally:
        os.unlink(path)
    ops = devtrace.in_stretch(tr)
    busy = devtrace.busy_intervals(ops)
    a, b = tr["stretch"]
    busy_s = sum(e - s for s, e in busy) * 1e-6
    rec = obs.rec
    ticks = [i for i, t in enumerate(rec.tick_info) if t["profiled"]]
    tset = set(ticks)
    st = {"busy_s": busy_s, "window_s": (b - a) * 1e-6, "ops": ops,
          "kernels": len(ops), "ticks": ticks,
          "tokens": sum(1 for tt in rec.token_ticks.values() for k in tt
                        if k in tset),
          "k1": devtrace.kernel_time(ops, K1_KERNEL),
          "k2": devtrace.kernel_time(ops, K2_KERNEL)}
    breakdown = {"device_ops": devtrace.top_ops(ops),
                 "idle_gaps": devtrace.idle_gaps(tr, busy)}
    return st, breakdown


def window_spans(obs, name: str, profiled: bool = False) -> list:
    """The traced calls of ``name`` that ran in the window: (t0, t1, what
    the wrapper noted); those of the profiled stretch only if asked."""
    rec = obs.rec
    prof = [k for k, t in enumerate(rec.tick_info) if t["profiled"]]
    lo = rec.tick_start[prof[0]] if prof and not profiled else None
    hi = rec.tick_end[prof[-1]] if lo is not None else None
    return [(t0, t1, x) for t0, t1, x in rec.spans.get(name, [])
            if obs.w0 <= t0 and t1 <= obs.w1
            and not (lo is not None and lo <= t0 <= hi)]


def window_stats(obs):
    """Tokens emitted in the window, the gaps between consecutive tokens
    of a request inside it, the time to first token of every request
    submitted in it (one still waiting counts its wait so far), and the
    requests attempted (served in the window or submitted in it)."""
    rec = obs.rec
    f, l = obs.first_tick, obs.last_tick
    ends = rec.tick_end
    tokens, gaps, ttfts, attempted = 0, [], [], 0
    for rid, ticks in rec.token_ticks.items():
        inside = [k for k in ticks if f <= k < l]
        tokens += len(inside)
        gaps += [ends[b] - ends[a] for a, b in zip(ticks, ticks[1:])
                 if a >= f and b < l]
        if inside or obs.w0 <= rec.submit_time.get(rid, -1.0) <= obs.w1:
            attempted += 1
    for rid, t in rec.submit_time.items():
        if not obs.w0 <= t <= obs.w1:      # after the last tick: not in it
            continue
        ticks = rec.token_ticks.get(rid, [])
        if ticks and ticks[0] < l:
            ttfts.append(ends[ticks[0]] - t)
        else:
            ttfts.append(obs.w1 - t)
    return tokens, gaps, ttfts, attempted


class HeadMaskProbe:
    """Takes, once, what the head-mask check needs: the importance and
    lengths that a head-mask update of the run read (the warm-up's, the
    window's outside the profiled stretch, or one just after the
    window), and the mask it made.  Before a tick (``before``) it reads
    the lengths, a small copy; where the update is due at this tick's
    clock (the longest length) and no layer reaches its rung first, it
    copies the importance on the device.  After the tick (``after``) it
    keeps the copy if the state's mask was replaced and no admission
    wrote a slot during the tick."""

    def __init__(self, c: dict, rungs: list[int]):
        s = c["spatten"]
        on = s["enable_head_pruning"] and s["head_keep"] > 0
        self.interval = s["head_update_interval"] if on else 0
        self.rungs = torch.tensor(rungs)[:, None]
        self.spare_ticks = 4 * self.interval + 8 if self.interval else 0
        self.got = None
        self._pending = None

    @property
    def done(self) -> bool:
        return self.got is not None or not self.interval

    def before(self, server) -> None:
        self._pending = None
        if self.done:
            return
        st = server.state
        lens = st.layer_lengths.cpu()
        if bool((lens + 1 > self.rungs).any()) or \
                int(lens.max()) % self.interval:
            return
        self._pending = (st.importance.clone(),
                         lens.amax(0).to(st.importance.device),
                         st.head_mask,
                         {q.request_id for q in server.active.values()})

    def after(self, server) -> None:
        if self._pending is None:
            return
        imp, lens, mask0, ids = self._pending
        self._pending = None
        mask = server.state.head_mask
        admitted = any(q.request_id not in ids
                       for q in server.active.values())
        if mask is not mask0 and not admitted:
            self.got = (imp, lens, mask)


def plan_sessions(server, spec: dict, seed: int, sessions, rungs: list[int],
                  tick0: int) -> dict:
    """When to copy the judged sessions' caches: ``judge_lead`` ticks
    before the tick at which one of a session's layers first reaches its
    capacity rung, so that its judged steps run through that compaction.
    A session decodes one token every tick, so from the lengths before
    the window (tick ``tick0``) that tick is known.  The sessions are
    ``judge_sessions`` of those (request ids ``sessions``) whose rung
    falls within ``judge_horizon`` ticks, drawn from the seed.
    {tick: [slot]}."""
    lead, horizon = spec.get("judge_lead", 0), spec.get("judge_horizon", 0)
    lens = server.state.layer_lengths.cpu().numpy()
    left = (np.asarray(rungs)[:, None] - lens).min(axis=0)    # per slot
    slots = sorted(s for s, q in server.active.items()
                   if q.request_id in sessions and lead <= left[s] <= horizon)
    rng = np.random.default_rng([int(seed), 2])
    plan: dict = {}
    for i in sorted(rng.permutation(len(slots))[:spec.get("judge_sessions",
                                                          0)]):
        plan.setdefault(tick0 + int(left[slots[i]]) - lead, []).append(
            slots[i])
    return plan


def snapshot(server, slot: int) -> tuple[dict, int]:
    """A session's cache as the program holds it before this tick, copied
    on the device (the planes are written in place), and the tokens it
    has served so far: (start, served)."""
    st = server.state
    start = {"k8": st.cache.k.full[:, slot].clone(),
             "ksc": st.cache.k.scale[:, slot].clone(),
             "v8": st.cache.v.full[:, slot].clone(),
             "vsc": st.cache.v.scale[:, slot].clone(),
             "imp": st.importance[:, slot].clone(),
             "lens": st.layer_lengths[:, slot].clone()}
    return start, len(server.active[slot].generated)


def sample_rows(obs, snaps: dict, seed: int, dev):
    """The judged rows: each judged session from its cache copied in the
    window (``snapshot``) for up to ``judge_session_steps`` decode steps,
    through its first compaction; ``judge_prefills`` staged sessions from
    their histories (the longest always), their first token against the
    reference's own prefill; and the requests whose first token came in
    the window (at most ``judge_requests``: the longest prompt always,
    the rest drawn from the seed), from their prompts, for
    ``judge_steps`` steps.  Only
    tokens served in the window count.  Each row holds the served tokens
    and, per decode step, the index of the head mask in force
    (``mask_table``).  Also returns the tallies compared with a floor:
    ``rows_across_prune``, the session rows whose judged steps hold the
    compaction (staged sessions only)."""
    rec, spec = obs.rec, obs.spec
    steps = spec["judge_steps"]
    f, l = obs.first_tick, obs.last_tick
    table = torch.stack([m for _, m in rec.masks]).cpu()
    mask_ticks = [t for t, _ in rec.masks]

    def mask_ids(ticks):
        return [int(np.searchsorted(mask_ticks, k, side="right")) - 1
                for k in ticks]

    def served(rid, n0, n):
        """Up to ``n`` tokens of request ``rid`` from its ``n0``-th on,
        those served in the window, with their ticks."""
        ticks = [k for k in rec.token_ticks[rid][n0:n0 + n] if k < l]
        return list(rec.requests[rid].generated[n0:n0 + len(ticks)]), ticks

    rows = []
    tallies = {}
    if obs.spec["kind"] == "staged_sessions":
        tallies["rows_across_prune"] = 0
    rungs = np.asarray(obs.rungs)
    for rid, (start, n0) in sorted(snaps.items()):
        start["lens"] = start["lens"].cpu().numpy()
        tokens, ticks = served(rid, n0, spec["judge_session_steps"] + 1)
        if len(tokens) > 1:
            rows.append({"start": start, "tokens": tokens,
                         "masks": mask_ids(ticks)})
            # decode step j prunes first where a length + 1 passes a rung
            first_prune = int((rungs - start["lens"]).min())
            tallies["rows_across_prune"] += len(tokens) - 2 >= first_prune
    # staged histories through the prefill path: the longest, and the
    # rest drawn from the seed
    staged = sorted(obs.sessions, key=lambda rid: (
        len(rec.requests[rid].prompt), rid))
    if staged:
        rng = np.random.default_rng([int(seed), 4])
        rest = [staged[i] for i in rng.permutation(len(staged) - 1)]
        for rid in ([staged[-1]] + rest)[:spec.get("judge_prefills", 0)]:
            req = rec.requests[rid]
            rows.append({"prompt": np.asarray(req.prompt),
                         "tokens": [req.generated[0]], "masks": [0]})
    pool = [rid for rid, t in rec.token_ticks.items()
            if rid in rec.submit_time and t and t[0] >= f
            and sum(1 for k in t if k < l) > steps]
    if pool:
        pool.sort(key=lambda rid: (len(rec.requests[rid].prompt), rid))
        rng = np.random.default_rng([int(seed), 3])
        rest = [pool[i] for i in rng.permutation(len(pool) - 1)]
        for rid in ([pool[-1]] + rest)[:spec["judge_requests"]]:
            tokens, ticks = served(rid, 0, steps + 1)
            rows.append({"prompt": np.asarray(rec.requests[rid].prompt),
                         "tokens": tokens, "masks": mask_ids(ticks)})
    if not rows:
        raise RuntimeError("nothing to judge: the window began no request "
                           "and judged no session")
    return rows, table, tallies


def gap_numbers(gaps: list, rows: list, chunk: int) -> dict:
    """The numbers read from per-row gaps: over first tokens that the
    prefill attention produced (a prompt whose last chunk has one token
    runs it as a decode step: that token counts with the decode steps)
    and over decode steps.  {name: (value, rule)}."""
    first, steps = [], []
    for g, r in zip(gaps, rows):
        if "prompt" in r and len(r["prompt"]) % chunk != 1:
            first.append(g[:1])
            steps.append(g[1:])
        else:
            steps.append(g)
    numbers = {"tokens_judged": (sum(g.numel() for g in gaps), ">=")}
    if first:
        first = torch.cat(first)
        numbers["first_gap_max"] = (float(first.max()), "<=")
        numbers["first_gap_mean"] = (float(first.mean()), "<=")
    steps = torch.cat(steps) if steps else torch.zeros(0)
    if steps.numel():
        numbers["gap_max"] = (float(steps.max()), "<=")
        numbers["gap_mean"] = (float(steps.mean()), "<=")
    return numbers


def control_readings(ref_mod, knobs, params: dict, rows: list, mask_table,
                     logits: list, dev) -> dict:
    """Readings of the numbers for two stand-ins judged at the same
    positions against the same float32 logits (``logits``, per row): the
    reference computed in float8 e4m3 put in the program's place (at each
    position the token it puts first), and a served token altered where
    it is produced (the reference's first token + 1)."""
    ref = ref_mod.Reference(knobs, params, dev, precision="fp8")
    low: list = []
    with torch.no_grad():
        ref_mod.judge(ref, rows, mask_table, low)
    del ref

    def gaps_of(pick):
        return [lg.max(-1).values - lg.gather(-1, pick(lg, lo)[:, None])[:, 0]
                for lg, lo in zip(logits, low)]
    fp8 = gaps_of(lambda lg, lo: lo.argmax(-1))
    altered = gaps_of(lambda lg, lo: (lg.argmax(-1) + 1) % lg.shape[-1])
    return {name: {n: v for n, (v, _) in
                   gap_numbers(g, rows, knobs.chunk).items()}
            for name, g in (("fp8", fp8), ("token_altered", altered))}


def verdict(numbers: dict, lim: dict) -> dict:
    """Each number that has a limit, held to it: {name: dict(value,
    limit, rule, ok)}."""
    out = {}
    for name, (value, rule) in numbers.items():
        if name not in lim:
            continue
        ok = value <= lim[name] if rule == "<=" else value >= lim[name]
        out[name] = dict(value=value, limit=lim[name], rule=rule, ok=ok)
    return out


def judge(c: dict, params: dict, rows: list, mask_table, probe, lim: dict,
          dev, gaps_out: list, control: str | None = None,
          readings_out: dict | None = None,
          tallies: dict | None = None, *, ref_mod) -> dict:
    """The numbers compared, each with its limit: the widest gap by which
    a served token's reference logit lies below the reference's best
    (``ref_mod``: the model path's reference);
    the tokens judged and the ``tallies`` of the sample; the serving head
    mask against the one the reference works out from the program's
    importance at the update the probe took.  With ``control`` "fp8" the
    stand-ins' readings are held to the same limits too
    (``readings_out["verdicts"]``: a stand-in the check passes would be
    a control it cannot see)."""
    readings_out = {} if readings_out is None else readings_out
    knobs = ref_mod.Knobs.from_config(c)
    out = {}
    if probe is not None:
        imp, lens, mask = probe
        ref_mask, sums = ref_mod.head_mask_from_importance(
            knobs, imp, lens, c["spatten"]["head_keep"])
        # a layer whose kept and dropped groups lie within 1e-5 of each
        # other may break the tie either way
        srt = torch.sort(sums, dim=-1, descending=True).values
        keep = min(c["spatten"]["head_keep"], knobs.kv_heads)
        tied = torch.zeros(knobs.layers, dtype=torch.bool,
                           device=sums.device)
        if keep < knobs.kv_heads:
            tied = ((srt[:, keep - 1] - srt[:, keep]).abs()
                    <= 1e-5 * srt[:, keep - 1].abs())
        diff = (ref_mask != mask.to(ref_mask.device)).any(-1) & ~tied
        mism = int(diff.sum())
        del imp, lens, probe
        out["head_mask_mismatch"] = dict(
            value=mism, limit=lim["head_mask_mismatch"], rule="<=",
            ok=mism <= lim["head_mask_mismatch"])
    prev_tf32 = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        logits = [] if control == "fp8" else None
        ref = ref_mod.Reference(knobs, params, dev)
        with torch.no_grad():
            gaps = ref_mod.judge(ref, rows, mask_table, logits)
        gaps_out.extend(gaps)
        del ref
        if control == "fp8":
            readings_out.update(control_readings(ref_mod, knobs, params,
                                                 rows, mask_table, logits,
                                                 dev))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev_tf32
    numbers = gap_numbers(gaps, rows, knobs.chunk)
    numbers.update({n: (v, ">=") for n, v in (tallies or {}).items()})
    readings_out["program"] = {n: v for n, (v, _) in numbers.items()}
    for name, (value, _) in numbers.items():
        if name not in lim:
            log(f"read {name}: {value!r} (no limit: not compared)")
    out.update(verdict(numbers, lim))
    for name in sorted(set(lim) - set(out)):
        # a number the run gave nothing to read (no head-mask update, no
        # first token) fails: a sound run of the cell always has it
        out[name] = dict(value=None, limit=lim[name], rule="read", ok=False)
    if control == "fp8":
        readings_out["verdicts"] = {}
        for name in ("fp8", "token_altered"):
            held = verdict({n: (v, "<=") for n, v in
                            readings_out[name].items()
                            if n != "tokens_judged"}, lim)
            readings_out["verdicts"][name] = {
                "correct": all(x["ok"] for x in held.values()),
                "failed": sorted(n for n, x in held.items() if not x["ok"])}
            log(f"control {name}: correct "
                f"{readings_out['verdicts'][name]['correct']} (fails "
                f"{readings_out['verdicts'][name]['failed']})")
    return out
