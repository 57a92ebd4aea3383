"""The port's tracer (``spatten_tpu_torch.utils.profiling.tracer``) on the
CPU: off by default and then silent and cheap; the server's tokens the
same with it on; the spans of a tick nested as the server and engine
open them, with their attributes; one ``sync.*`` span per device-to-host
read of the tick's path; the profiler ranges the spans open; and the
numbers ``portbench.program_trace`` reads from the spans, on synthetic
spans and over a tiny cell run by the harness."""

import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import program_trace as pt
from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.engine.server import SpAttenServer
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.utils import annotate
from spatten_tpu_torch.utils.profiling import OFF, Span, tracer

torch.set_num_threads(1)


def cfg_batch(b):
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig.tiny(),
        pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                   recent_size=8, v_keep_ratio=0.5,
                                   v_block_size=4),
        quant=tcfg.QuantConfig(requant_threshold=0.1),
        engine=tcfg.EngineConfig(max_batch_size=b, cache_capacity=32,
                                 prefill_chunk=8),
    ).validate()


def params(seed=4):
    return transformer.init_params(cfg_batch(1).model, seed,
                                   dtype=torch.float32, device="cpu")


# more requests than slots, prompts over several chunks and past the
# capacity (the admissions prune), budgets that release out of order
REQUESTS = [((np.arange(n) * m + 5) % 250, new) for n, m, new in
            ((5, 3, 6), (21, 7, 3), (12, 11, 9), (40, 5, 4), (3, 13, 7),
             (17, 2, 5))]


@pytest.fixture
def traced():
    """The tracer on for the test, off and empty after it."""
    tracer.drain()
    tracer.enable()
    yield tracer
    tracer.disable()
    tracer.drain()


def serve(batch, eos=None, requests=REQUESTS):
    srv = SpAttenServer(params(), cfg_batch(batch), eos_token_id=eos,
                        device="cpu")
    ids = [srv.submit(p, new) for p, new in requests]
    order, ticks = [], 0
    while srv.active or srv.pending or srv.admitting:
        order += [(ticks, r.request_id, tuple(r.generated))
                  for r in srv.step()]
        ticks += 1
    return ids, order, sorted(srv.free_slots), ticks


def one_tick(srv=None):
    """Spans of one traced tick that starts and finishes an admission (a
    one-chunk prompt) and decodes the slot already active."""
    srv = srv or SpAttenServer(params(), cfg_batch(2), device="cpu")
    srv.submit(np.arange(12) % 250, max_new_tokens=6)
    srv.step()
    srv.step()
    rid = srv.submit(np.arange(6) * 3 % 250, max_new_tokens=3)
    tracer.drain()
    tracer.enable()
    try:
        srv.step()
    finally:
        tracer.disable()
    return rid, tracer.drain()


def test_disabled_tracer_records_nothing():
    assert not tracer.on
    assert tracer.span("server.tick", rows=1) is OFF
    assert tracer.sync("server.tokens") is OFF
    with tracer.span("engine.prune") as sp:
        sp.note(layers=3)
    serve(2, requests=REQUESTS[:3])
    assert tracer.drain() == []


def test_disabled_site_costs_under_a_microsecond():
    """A span site with the tracer off (an attribute check and the shared
    no-op context): the best of 5 loops of 20,000, per site."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(20000):
            with tracer.span("engine.prefill", rows=1, tokens=128):
                pass
        best = min(best, time.perf_counter() - t0)
    assert best / 20000 < 1e-6
    assert tracer.drain() == []


@pytest.mark.parametrize("batch,eos", [(2, None), (3, None), (2, 1)])
def test_server_tokens_same_with_tracer_on(batch, eos):
    """The server's tokens, completion order, ticks and free slots with
    the tracer off and on (the scenarios of ``test_torch_server.py``
    against JAX: admissions that prune, slots reused, EOS release)."""
    off = serve(batch, eos)
    tracer.enable()
    try:
        on = serve(batch, eos)
    finally:
        tracer.disable()
    spans = tracer.drain()
    assert on == off
    assert sum(s.name == "server.tick" for s in spans) == off[3]


def test_spans_nest_under_the_tick():
    rid, spans = one_tick()
    names = [s.name for s in spans]
    assert names[0] == "server.tick" and spans[0].parent == -1
    assert all(s.parent >= 0 for s in spans[1:])
    assert all(s.parent < i for i, s in enumerate(spans) if s.parent >= 0)
    assert all(s.t0 >= spans[s.parent].t0 and s.t1 <= spans[s.parent].t1
               for s in spans[1:])

    def parent(s):
        return spans[s.parent].name

    kids = [s.name for s in spans if s.parent == 0]
    assert kids == ["server.admit", "server.admission",
                    "server.decode_input", "engine.decode", "server.release"]
    adm = [s for s in spans if s.name == "server.admission"]
    assert [s.attrs for s in adm] == [{"request": rid}]
    pre = [s for s in spans if s.name == "engine.prefill"]
    assert [(parent(s), s.attrs) for s in pre] == [
        ("server.admission", {"rows": 1, "tokens": 6})]
    assert [parent(s) for s in spans if s.name == "server.write_slot"] == [
        "server.admission"]
    assert sorted(parent(s) for s in spans if s.name == "engine.prune") == [
        "engine.decode", "engine.prefill"]
    assert sorted(parent(s) for s in spans if s.name == "model.forward") == [
        "engine.decode", "engine.prefill"]
    # the plain K1 and K2 on the CPU launch nothing
    assert "k1.launch" not in names and "k2.launch" not in names


def test_each_read_of_the_tick_has_one_sync_span():
    """Every device-to-host read of a tick's path in its own ``sync.*``
    span, each under the span of the code that makes it: the admission's
    state, prompt ids and first token, each prune's trigger check, the
    head-mask clock, the decode ids and the served tokens."""
    _, spans = one_tick()
    syncs = [(s.name, spans[s.parent].name) for s in spans
             if s.name.startswith("sync.")]
    prune = [("sync.prune.caps", "engine.prune"),
             ("sync.prune.layers", "engine.prune"),
             ("sync.prune.budgets", "engine.prune")]
    assert syncs == [
        ("sync.state.quant_bits", "server.admit"),
        ("sync.server.prompt_ids", "server.admission")] + prune + [
        ("sync.server.first_token", "server.admission"),
        ("sync.server.decode_ids", "server.decode_input")] + prune + [
        ("sync.head_mask.clock", "engine.decode"),
        ("sync.server.tokens", "server.release")]
    # a read's span holds the read alone
    assert not any(spans[s.parent].name.startswith("sync.")
                   for s in spans if s.parent >= 0)


def test_compacting_prune_notes_its_layers(traced):
    """An admission whose prompt passes the capacity compacts: its prune
    span carries the layers it compacted; the others carry none."""
    serve(2, requests=[((np.arange(40) * 5 + 5) % 250, 2)])
    prunes = [s.attrs for s in traced.drain() if s.name == "engine.prune"]
    assert any(a.get("layers", 0) > 0 for a in prunes)
    assert {} in prunes


def test_spans_open_profiler_ranges(traced):
    """Under a recording ``torch.profiler`` each span is also a range of
    its name on the profiler's timeline (``annotate``)."""
    srv = SpAttenServer(params(), cfg_batch(2), device="cpu")
    srv.submit(np.arange(6) % 250, max_new_tokens=4)      # one chunk
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.step()
    with annotate("outside"):
        pass
    names = {e.key for e in prof.key_averages()}
    assert {"server.tick", "server.admission", "engine.prefill",
            "engine.decode", "model.forward", "sync.server.tokens"} <= names


def test_drain_refuses_an_open_span(traced):
    with traced.span("server.tick"):
        with pytest.raises(RuntimeError, match="server.tick"):
            traced.drain()
    assert [s.name for s in traced.drain()] == ["server.tick"]


# ------------------------------------------------ the numbers, synthetic
def synthetic():
    """Five ticks (100 ms apart): tick 0 before the window, ticks 1-2 in
    it outside the profiled stretch, tick 3 profiled, tick 4 after the
    window; a staging prefill outside every tick.  Times in ms; each tick
    [0, 80] holds an admission [1, 31] (prompt ids [2, 3], a prefill
    [4, 30] of ``rows`` with a prune check [5, 6]), a decode [32, 72]
    (a prune read [33, 35], a forward [36, 70] with two K1 launches of
    0.5 and 0.3) and a release [73, 78] (the tokens read [73, 77]; in the
    profiled tick release [73, 79] and read [73, 78])."""
    spans = []

    def add(name, a, b, parent=-1, **attrs):
        s = Span(tracer, name, attrs)
        s.t0, s.t1, s.parent = int(a * 1e6), int(b * 1e6), parent
        spans.append(s)
        return len(spans) - 1

    add("engine.prefill", 1, 40, rows=16)            # staging
    for k, rows in enumerate((5, 1, 2, 1, 7)):
        o = 100.0 * (k + 1)
        t = add("server.tick", o, o + 80)
        a = add("server.admission", o + 1, o + 31, t, request=k)
        add("sync.server.prompt_ids", o + 2, o + 3, a)
        p = add("engine.prefill", o + 4, o + 30, a, rows=rows, tokens=8)
        add("sync.prune.caps", o + 5, o + 6, p)
        d = add("engine.decode", o + 32, o + 72, t)
        add("sync.prune.layers", o + 33, o + 35, d)
        f = add("model.forward", o + 36, o + 70, d)
        add("k1.launch", o + 40, o + 40.5, f)
        add("k1.launch", o + 50, o + 50.3, f)
        end = 79 if k == 3 else 78
        r = add("server.release", o + 73, o + end, t)
        add("sync.server.tokens", o + 73, o + end - 1, r)
    starts = [100.0 * (k + 1) * 1e-3 - 1e-3 for k in range(5)]
    rec = SimpleNamespace(
        tick_start=starts, tick_end=[s + 0.082 for s in starts],
        tick_info=[{"profiled": k == 3} for k in range(5)])
    return SimpleNamespace(rec=rec, first_tick=1, last_tick=4), spans


def test_issue_ms_leaves_out_the_syncs_and_the_stretch():
    # children 30 + 40 + 5, their syncs 1 + 1 + 2 + 4, in ticks 1-2
    assert pt.issue_ms(*synthetic()) == pytest.approx(67.0)


def test_sync_wait_ms_reads_the_stretch():
    # the profiled tick's reads: 1 + 1 + 2 + 5
    assert pt.sync_wait_ms(*synthetic()) == pytest.approx(9.0)


def test_syncs_per_tick_over_the_window():
    assert pt.syncs_per_tick(*synthetic()) == pytest.approx(4.0)


def test_prefill_rows_under_admissions_in_the_window():
    # ticks 1-3 carry 1, 2, 1 rows; staging and ticks 0 and 4 do not count
    assert pt.prefill_rows(*synthetic()) == pytest.approx(4 / 3)


def test_decode_issue_ms_leaves_out_its_syncs():
    assert pt.decode_issue_ms(*synthetic()) == pytest.approx(38.0)


def test_k1_host_us_outside_the_stretch():
    assert pt.k1_host_us(*synthetic()) == pytest.approx(400.0)


def test_tick_split_covers_the_tick():
    split = pt.tick_split(*synthetic())
    out, st = split["outside"], split["stretch"]
    assert (out["ticks"], st["ticks"]) == (2, 1)
    assert out["children_ms"] == pytest.approx(75.0)
    assert out["self_ms"] == pytest.approx(5.0)
    assert out["between_ms"] == pytest.approx(20.0)
    assert st["children_share"] == pytest.approx(76 / 80)
    assert out["syncs"]["sync.server.tokens"] == pytest.approx([1.0, 4.0])


def test_by_name_splits_self_time():
    names = pt.by_name(*synthetic())
    assert names["server.tick"] == pytest.approx([1.0, 80.0, 5.0])
    assert names["engine.decode"] == pytest.approx([1.0, 40.0, 4.0])
    assert names["k1.launch"] == pytest.approx([2.0, 0.8, 0.8])


def test_idle_gaps_nested_looks_back_past_many_ops():
    """A gap in a span that opened more than 4,000 host ops before it:
    ``devtrace.idle_gaps`` reads it as outside any op, the nested reading
    puts it under the span; a gap between spans stays outside."""
    from portbench import devtrace
    ops = [(1.0 + i, 1.5 + i, "aten::add") for i in range(4100)]
    tr = {"stretch": (0.0, 20000.0),
          "host": sorted([(0.0, 10000.0, "server.admission")] + ops)}
    busy = [[0.0, 9000.0], [9500.0, 12000.0], [12500.0, 20000.0]]
    assert devtrace.idle_gaps(tr, busy) == [["host outside any op",
                                             pytest.approx(1e-3)]]
    assert pt.idle_gaps_nested(tr, busy) == [
        ["server.admission", pytest.approx(5e-4)],
        ["host outside any op", pytest.approx(5e-4)]]


def test_numbers_of_a_tiny_traced_run(tmp_path):
    """The harness's traced run of a tiny chat cell on the CPU with the
    tracer on: every number but K1's (no launch on the CPU) reads, from
    batch-1 admissions, and the tick's children cover it.  (The tiny
    cell's limits are for the reference's tests; ``correct`` is not
    asked here.)"""
    from portbench import harness
    from portbench.tests import tiny
    root, bdir, bench = tiny.make_root(Path(tmp_path))
    with pt.taken() as seen:
        out = harness.run("tiny.chat", 2 ** 31 + 7, 1.5, True,
                          t_start=time.perf_counter(), device="cpu",
                          root=root, bench=bench, bench_dir=bdir)
    assert not tracer.on
    rep = pt.report(seen["obs"], seen["spans"], seen["trace"])
    nums = rep["numbers"]
    assert out["metrics"] and "idle_gaps" in out["breakdown"]
    assert nums["k1.host_us"] is None
    assert all(nums[k] is not None and nums[k] > 0 for k in nums
               if k != "k1.host_us")
    assert nums["server.prefill_rows"] == 1.0
    assert 1 <= rep["chunks_per_admission"] <= 3          # prompts <= 80
    assert 1 <= rep["prefill_tokens"] <= 32
    assert rep["split"]["outside"]["children_share"] > 0.9
    assert rep["cost"]["off_us"] < rep["cost"]["on_us"]
    assert rep["idle_gaps_nested"] and rep["outside_any_op_s"] >= 0.0
