"""The harness's hold on the program: what it patches, when it reads the
device, and which sessions the check follows through a compaction."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from portbench import harness
import spatten_tpu_torch.engine.generate as gen


def test_untraced_run_patches_nothing():
    rec = harness.Record(trace=False)
    before = gen.decode_step, gen.update_head_mask, gen.maybe_prune
    w = harness.Wrapped(rec, torch.device("cpu"), None)
    assert w.saved == []
    assert (gen.decode_step, gen.update_head_mask, gen.maybe_prune) == before
    w.restore()


def test_profiled_calls_neither_sync_nor_read(monkeypatch):
    """Inside the profiled stretch a wrapped call keeps its device tensors
    and synchronises nothing; ``settle`` reads them afterwards."""
    synced = []
    monkeypatch.setattr(harness, "_sync", lambda dev: synced.append(dev))
    rec = harness.Record(trace=True)
    w = harness.Wrapped(rec, torch.device("cpu"), None)
    w.restore()
    trig = torch.tensor([True, False])
    wrapped = w._timed("engine.maybe_prune", w._prune_info)(
        lambda *a: (None, trig))
    rec.profiling = True
    wrapped()
    assert synced == []
    assert rec.spans["engine.maybe_prune"][0][2] is trig
    rec.profiling = False
    wrapped()
    assert len(synced) == 2
    rec.settle()
    assert [x for _, _, x in rec.spans["engine.maybe_prune"]] == [True, True]


def test_plan_copies_sessions_before_their_rung():
    """A session is copied ``judge_lead`` ticks before the tick at which
    its first layer reaches its rung, if that falls within the horizon;
    churn slots and far rungs are left out."""
    rungs = [16, 8]
    lens = torch.tensor([[10, 4, 2, 15],          # layer 0
                         [3, 7, 1, 2]])            # layer 1
    reqs = {s: SimpleNamespace(request_id=100 + s) for s in range(4)}
    server = SimpleNamespace(state=SimpleNamespace(layer_lengths=lens),
                             active=reqs)
    spec = {"judge_lead": 1, "judge_horizon": 5, "judge_sessions": 8}
    plan = harness.plan_sessions(server, spec, 3, {100, 101, 102}, rungs,
                                 tick0=50)
    # slot 0: 5 ticks to layer 1's rung; slot 1: 1; slot 2: 7 (too far);
    # slot 3 is not a session
    assert plan == {54: [0], 50: [1]}
    left = np.asarray(rungs)[:, None] - lens.numpy()
    assert left.min(axis=0).tolist() == [5, 1, 7, 1]
