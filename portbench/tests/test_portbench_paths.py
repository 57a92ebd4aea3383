"""Model paths: a configuration names the module that supplies its model
(``manifest.path``), the harness calls the model only through it, and
a traced run hands the program's spans to the readers."""

from __future__ import annotations

import json
import time

import pytest
import torch

from portbench import harness, manifest, program_trace
from portbench.tests import tiny
from portbench.weights import make_params

PROGRAM_READERS = ("server.issue_ms", "server.sync_wait_ms",
                   "server.syncs_per_tick", "server.prefill_rows",
                   "engine.decode_issue_ms", "k1.host_us",
                   "engine.prefill_graphed_share")

# the model arithmetic a path's ``counts`` supplies (``paths/__init__.py``)
MODEL_COUNTS = ("token_flops", "attention_flops", "chunk_context",
                "k1_bytes", "k2_bytes")

# a second path, written into the run's root as a new file: the llama
# path behind a layer that notes each call the harness makes through it;
# its counts hold the model arithmetic alone, so a reader that took a
# peak or the percentile through the path would fail
WRAPPED = '''
import types

from portbench import manifest

llama = manifest.path({})

CALLS = []


def _noted(name, fn):
    def call(*a, **kw):
        CALLS.append(name)
        return fn(*a, **kw)
    return call


program_config = _noted("program_config", llama.program_config)
make_params = _noted("make_params", llama.make_params)
_ref = llama.reference
reference = types.SimpleNamespace(
    Knobs=types.SimpleNamespace(
        from_config=_noted("Knobs.from_config", _ref.Knobs.from_config)),
    Reference=_noted("Reference", _ref.Reference),
    judge=_noted("judge", _ref.judge),
    head_mask_from_importance=_noted("head_mask_from_importance",
                                     _ref.head_mask_from_importance))
counts = types.SimpleNamespace(**{
    k: _noted("counts." + k, getattr(llama.counts, k))
    for k in MODEL_COUNTS})
'''


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plain(c: dict) -> dict:
    """``c`` in float32 with the serving flags the reference leaves to the
    program's precision off, so a clean run is correct at the tiny
    cells' limits."""
    c["engine"]["param_dtype"] = "float32"
    c["spatten"].update(quantize_queries=False, pv_int8=False,
                        probs_bf16=False)
    return c


def test_config_without_path_is_llama(tmp_path):
    c = manifest.config(manifest.load(), "deepseek-llm-7b-chat")
    assert "path" not in c
    mod = manifest.path(c)
    assert mod.__file__ == str(manifest.BENCH_DIR / "paths" / "llama.py")
    assert manifest.path(c) is mod                       # loaded once
    for name in ("program_config", "make_params", "reference", "counts"):
        assert hasattr(mod, name), name
    assert mod.reference.__name__ == "portbench.reference.spatten_ref"
    assert mod.counts.__name__ == "portbench.counts"
    with pytest.raises(FileNotFoundError):
        manifest.path(dict(c, path="no-such-model"), tmp_path)
    with pytest.raises(ValueError):
        manifest.path(dict(c, path="../llama"))


def _drawn_in_order(c: dict, seed: int, dtype) -> dict:
    """The weights as ``weights.make_params`` drew them before they moved
    behind the path: one generator from the seed, the leaves in this
    order, N(0, 1/fan_in), norms 1."""
    gen = torch.Generator().manual_seed(seed)
    L, d, v = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"]
    hq, hkv = c["num_attention_heads"], c["num_key_value_heads"]
    dh, f = d // hq, c["intermediate_size"]
    out = {}
    for name, shape, fan_in in (
            ("layers.wq", (L, d, hq * dh), d),
            ("layers.wk", (L, d, hkv * dh), d),
            ("layers.wv", (L, d, hkv * dh), d),
            ("layers.wo", (L, hq * dh, d), hq * dh),
            ("layers.w_gate", (L, d, f), d), ("layers.w_up", (L, d, f), d),
            ("layers.w_down", (L, f, d), f), ("embed", (v, d), d),
            ("lm_head", (d, v), d)):
        out[name] = torch.randn(shape, generator=gen, dtype=dtype).mul_(
            1.0 / fan_in ** 0.5)
    for name, shape in (("layers.attn_norm_w", (L, d)),
                        ("layers.mlp_norm_w", (L, d)),
                        ("final_norm_w", (d,))):
        out[name] = torch.ones(shape, dtype=dtype)
    return out


def test_llama_weights_equal_the_old_name():
    """The default path's weights are the old name's, drawn in the order
    the harness drew them before the move: a seed gives the same
    tensors."""
    c = tiny.tiny_config()
    mod = manifest.path(c)
    assert make_params is mod.make_params
    p = mod.make_params(c, 2 ** 31 + 9, "cpu", torch.bfloat16)
    got = {**{k: v for k, v in p.items() if k != "layers"},
           **{"layers." + k: v for k, v in p["layers"].items()}}
    want = _drawn_in_order(c, 2 ** 31 + 9, torch.bfloat16)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def test_a_new_path_runs_as_new_files(tmp_path):
    """A config naming a path that exists only as a new file under the
    run's root runs end to end, correct, untraced and traced, and the
    harness reaches the model only through it; the readers take the
    model's arithmetic through it and the peaks and the percentile from
    ``counts.py``."""
    root, bdir, bench = tiny.make_root(tmp_path)
    (bdir / "paths" / "wrapped.py").write_text(
        WRAPPED.replace("MODEL_COUNTS", repr(MODEL_COUNTS)))
    c = _plain(tiny.tiny_config())
    c["path"] = "wrapped"
    (bdir / "configs" / "tiny.json").write_text(json.dumps(c))
    mod = manifest.path(c, bdir)
    for trace in (False, True):
        out = harness.run("tiny.chat", 5, 2.0, trace,
                          t_start=time.perf_counter(), device="cpu",
                          root=root, bench=bench, bench_dir=bdir)
        assert out["correct"], out["compared"]
        assert out["metrics"], out
    assert {"program_config", "make_params", "Knobs.from_config",
            "Reference", "judge", "head_mask_from_importance",
            "counts.token_flops"} <= set(mod.CALLS), mod.CALLS
    assert "step.mfu" in out["metrics"]


def test_program_readers_read_only_a_traced_run(tmp_path, monkeypatch):
    """The readers of the program's spans give numbers in a traced run
    (K1's host time has no launch to read on the CPU, and every chunk
    runs eagerly there), the same as ``program_trace`` reads from the
    spans the harness kept, and nothing in an untraced run."""
    from spatten_tpu_torch.utils.profiling import tracer
    root, bdir, bench = tiny.make_root(tmp_path)
    seen = []
    stats = harness.window_stats
    monkeypatch.setattr(harness, "window_stats",
                        lambda obs: seen.append(obs) or stats(obs))
    out = harness.run("tiny.chat", 2 ** 31 + 3, 1.5, True,
                      t_start=time.perf_counter(), device="cpu", root=root,
                      bench=bench, bench_dir=bdir)
    assert not tracer.on
    obs = seen[-1]
    assert obs.program
    got = {n: out["metrics"].get(n, {}).get("value") for n in PROGRAM_READERS}
    assert got.pop("k1.host_us") is None
    assert got.pop("engine.prefill_graphed_share") == 0.0
    assert all(v is not None and v > 0 for v in got.values()), got
    assert {n: program_trace.NUMBERS[n](obs, obs.program)
            for n in got} == got
    harness.run("tiny.chat", 2 ** 31 + 3, 0.5, False,
                t_start=time.perf_counter(), device="cpu", root=root,
                bench=bench, bench_dir=bdir)
    assert seen[-1].program is None and not tracer.on
    for name in PROGRAM_READERS:
        assert manifest.reader(name, bdir)(seen[-1]) is None, name


def test_issue_numbers_leave_out_the_wrappers_drains():
    """The wrappers' synchronisations (``Record.drains``) inside a tick's
    child spans are device waits, not the host's issue: ``issue_ms``,
    ``decode_issue_ms`` and the split leave them out, with the program's
    ``sync.*`` spans.  One tick [0, 80] ms in the window: an admission
    [1, 31] holding a prompt read [2, 3] and the prefill wrapper's drains
    [4, 14] and [28, 30]; a decode [32, 72] holding a prune drain [40, 41];
    the decode wrapper's drain [73, 75] between children."""
    from types import SimpleNamespace
    from spatten_tpu_torch.utils.profiling import Span, tracer
    spans = []

    def add(name, a, b, parent=-1):
        s = Span(tracer, name, {})
        s.t0, s.t1, s.parent = int(a * 1e6), int(b * 1e6), parent
        spans.append(s)
        return len(spans) - 1

    t = add("server.tick", 0, 80)
    a = add("server.admission", 1, 31, t)
    add("sync.server.prompt_ids", 2, 3, a)
    add("engine.decode", 32, 72, t)
    ms = 1e-3
    rec = SimpleNamespace(
        tick_start=[-ms], tick_end=[81 * ms], tick_info=[{"profiled": False}],
        drains=[(4 * ms, 14 * ms), (28 * ms, 30 * ms), (40 * ms, 41 * ms),
                (73 * ms, 75 * ms)])
    obs = SimpleNamespace(rec=rec, first_tick=0, last_tick=1)
    assert program_trace.issue_ms(obs, spans) == pytest.approx(70 - 1 - 13)
    assert program_trace.decode_issue_ms(obs, spans) == pytest.approx(39)
    out = program_trace.tick_split(obs, spans)["outside"]
    assert out["drain_ms"] == pytest.approx(13)
    assert out["issue_ms"] == pytest.approx(56)
    rec.drains = []
    assert program_trace.issue_ms(obs, spans) == pytest.approx(69)
