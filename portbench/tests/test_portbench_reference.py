"""The plain reference against the port on a tiny config on the CPU, and
the check that decides ``correct``: a clean run passes; the control (the
port serving from weight-only int8 weights) and a run with the timed
path broken underneath fail."""

from __future__ import annotations

import json
import time

import pytest
import torch

import spatten_tpu_torch.engine.generate as gen
from spatten_tpu_torch.engine.server import SpAttenServer
from spatten_tpu_torch.models import transformer
from portbench import harness, manifest
from portbench.reference import spatten_ref
from portbench.tests import tiny
from portbench.traffic import generate as traffic_gen
from portbench.weights import make_params

# the serving flags the reference leaves to the program's precision
PLAIN = {"quantize_queries": False, "pv_int8": False, "probs_bf16": False}


def plain_config() -> dict:
    c = tiny.tiny_config()
    c["engine"]["param_dtype"] = "float32"
    c["spatten"].update(PLAIN)
    return c


@pytest.mark.parametrize("history", [(200, 240), (200, 300)])
def test_reference_equals_the_port_plain_path(history):
    """The port's server in f32 (the kernels' plain versions on the CPU)
    and the reference give the same logits at every served token through
    prefill, prunes, requants, V pruning and head-mask updates (the
    second case: a 225-token prompt, whose last chunk of one token runs
    as a decode step, and a 275-token one that prunes in its prefill).
    The scales are f32 here: K1 scores and weighs the appended token with
    its f32 scale where the reference reads the stored one."""
    c = plain_config()
    c["spatten"]["scale_dtype"] = "float32"
    cfg = manifest.path(c).program_config(c)
    params = make_params(c, 11, "cpu", torch.float32)
    srv = SpAttenServer(params, cfg, device="cpu")
    spec = dict(tiny.TRAFFIC["long"], history_min=history[0],
                history_max=history[1], history_groups=2)
    reqs = traffic_gen.Traffic(spec, 11, 2, c["vocab_size"]).staged()
    for r in reqs:
        srv.submit(r.prompt, 90)
    seen, masks = [], []
    fwd = transformer.forward

    def spy(p, cfg_, state, tokens, **kw):
        out = fwd(p, cfg_, state, tokens, **kw)
        if tokens.shape[1] == 1:
            seen.append(out[0][:, -1].clone())
            masks.append(state.head_mask.clone())
        return out

    steps: dict = {}                     # request id -> its decode steps
    done = []
    gen.transformer.forward = spy
    try:
        while srv.pending or srv.admitting or srv.active:
            finished = srv.step()
            for r in list(srv.active.values()) + finished:
                got = steps.setdefault(r.request_id, [])
                if len(r.generated) > len(got):
                    got.append(len(seen) - 1)
            done += finished
    finally:
        gen.transformer.forward = fwd
    assert len(done) == 2 and all(len(r.generated) == 90 for r in done)
    assert steps[0] != steps[1]          # the two joined on other ticks
    table = torch.stack(masks)
    ref = spatten_ref.Reference(spatten_ref.Knobs.from_config(c), params,
                                "cpu")
    rows, progs = [], []
    for r in sorted(done, key=lambda q: q.request_id):
        own = steps[r.request_id]
        rows.append({"prompt": r.prompt, "tokens": list(r.generated),
                     "masks": own})
        progs.append(torch.stack([seen[k][r.slot] for k in own[:-1]]))
    logits = []
    gaps = spatten_ref.judge(ref, rows, table, logits_out=logits)
    for b in range(2):
        diff = (logits[b][1:] - progs[b]).abs().max()
        assert float(diff) < 1e-4, float(diff)
        assert float(gaps[b].max()) == 0.0


def _run(tmp_path, cell, *, control=None, seed=5, seconds=2.0):
    root, bdir, bench = tiny.make_root(tmp_path)
    (bdir / "configs" / "tiny.json").write_text(json.dumps(plain_config()))
    return harness.run(cell, seed, seconds, False, t_start=time.perf_counter(),
                       device="cpu", root=root, bench=bench, bench_dir=bdir,
                       control=control, keep_gaps=control == "fp8")


@pytest.mark.parametrize("cell", ["tiny.long", "tiny.chat"])
def test_clean_run_is_correct(tmp_path, cell):
    out = _run(tmp_path, cell)
    assert out["correct"], out["compared"]
    assert list(out)[-1] == "compared"


def test_control_fails(tmp_path):
    out = _run(tmp_path, "tiny.long", control="int8")
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("cell", ["tiny.long", "tiny.chat"])
def test_stand_ins_fail_a_limit(tmp_path, cell):
    """The fp8 reference and the altered token, read at the judged
    positions and held to the cell's limits, each come out not correct."""
    out = _run(tmp_path, cell, control="fp8")
    assert out["correct"], out["compared"]
    for name in ("fp8", "token_altered"):
        got = out["readings"][name]
        assert any(got.get(n, 0.0) > x["limit"]
                   for n, x in out["compared"].items()
                   if x["rule"] == "<="), (name, got)
        held = out["readings"]["verdicts"][name]
        assert not held["correct"] and held["failed"], (name, held)


def _state_unchanged(orig):
    def decode_step(params, cfg, state, token):
        nt, _, aux = orig(params, cfg, state, token)
        return nt, state, aux
    return decode_step


def _half_batch(orig):
    def decode_step(params, cfg, state, token):
        nt, st, aux = orig(params, cfg, state, token)
        half = nt.shape[0] // 2
        nt = nt.clone()
        nt[half:] = nt[:nt.shape[0] - half]
        return nt, st, aux
    return decode_step


def _token_altered(orig):
    def decode_step(params, cfg, state, token):
        nt, st, aux = orig(params, cfg, state, token)
        return (nt + 1) % cfg.model.vocab_size, st, aux
    return decode_step


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_broken_step_fails(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(gen, "decode_step", fault(gen.decode_step))
    out = _run(tmp_path, "tiny.long")
    assert not out["correct"], out["compared"]
