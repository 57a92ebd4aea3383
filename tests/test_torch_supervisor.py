"""Checkpoint / resume and supervised decode in the port vs the JAX
package, on the CPU.

``engine.checkpoint``: a state-only snapshot, a params + state + extra
snapshot and a legacy payload (no ``layer_lengths`` / ``quant_bits``)
round-trip byte for byte (bf16 scales and importance included), and a
JAX orbax snapshot restored and converted (``convert.state_from_jax``)
equals the port's round trip of the same state.

``engine.supervisor.generate_supervised`` on ``tests/test_supervisor.py``'s
tiny configuration (ModelConfig.tiny(), capacity 64, window 8, 24 new
tokens; prunes and requants fire) from the same f32 weights (bf16
weights, JAX's default, round differently in the two frameworks and
part greedy streams after ~20 steps): the
uninterrupted run, a run whose health probe fails before windows 2 and 3
(the latest snapshot is restored and the window replays) and a run that
stops at 16 tokens and is resumed from disk to 24 give greedy tokens
equal to JAX's ``generate_supervised`` in each of the three ways, exactly.
The restart budget and a resume window off the snapshot's raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import checkpoint as jckpt
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine.supervisor import (
    generate_supervised as j_supervised,
)
from spatten_tpu.models import transformer as jtr

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax, state_from_jax
from spatten_tpu_torch.engine import checkpoint as tckpt
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine.supervisor import (
    generate_supervised as t_supervised,
)

torch.set_num_threads(1)

WINDOW, NEW = 8, 24


def build(mod, **quant):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=24,
                                  recent_size=16, v_block_size=8),
        quant=mod.QuantConfig(enabled=True, enable_requant=True,
                              requant_threshold=0.2, **quant),
        engine=mod.EngineConfig(max_batch_size=2, cache_capacity=64,
                                prefill_chunk=16, decode_window=WINDOW),
    ).validate()


@pytest.fixture(scope="module")
def setup():
    jc, tc = build(jcfg), build(tcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    prompt = np.random.default_rng(1).integers(
        0, jc.model.vocab_size, (2, 20)).astype(np.int32)
    return jc, tc, jparams, tparams, prompt


def flaky():
    """A probe that fails before windows 2 and 3 (calls 2 and 3)."""
    calls = {"n": 0}

    def health():
        calls["n"] += 1
        return calls["n"] not in (2, 3)
    return health, calls


@pytest.fixture(scope="module")
def jax_runs(setup, tmp_path_factory):
    jc, _, jparams, _, prompt = setup
    d = tmp_path_factory.mktemp("jax")
    p = jnp.asarray(prompt)
    want = np.asarray(j_supervised(jparams, jc, p, NEW, str(d / "a"),
                                   window=WINDOW, health=lambda: True))
    health, _ = flaky()
    killed = np.asarray(j_supervised(jparams, jc, p, NEW, str(d / "b"),
                                     window=WINDOW, health=health))
    j_supervised(jparams, jc, p, 16, str(d / "r"), window=WINDOW,
                 health=lambda: True)
    resumed = np.asarray(j_supervised(jparams, jc, p, NEW, str(d / "r"),
                                      window=WINDOW, health=lambda: True,
                                      resume=True))
    return {"uninterrupted": want, "killed": killed, "resumed": resumed}


def equal_states(a, b):
    for x, y in zip(a.cache.k + a.cache.v, b.cache.k + b.cache.v):
        assert (x is None) == (y is None)
        if x is not None:
            assert x.dtype == y.dtype and torch.equal(x, y)
    for name in ("importance", "lengths", "layer_lengths", "head_mask",
                 "requant_events", "quant_bits"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


@pytest.fixture(scope="module")
def bf16_state(setup):
    """A decoded state with bf16 scales and importance (prunes fired)."""
    _, _, _, tparams, prompt = setup
    tc = build(tcfg, scale_dtype="bfloat16")
    tc = dataclasses.replace(tc, pruning=dataclasses.replace(
        tc.pruning, importance_dtype="bfloat16")).validate()
    res = tgen.generate(tparams, tc, torch.from_numpy(prompt), 60,
                        device="cpu")
    assert res.state.importance.dtype == torch.bfloat16
    assert res.state.cache.k.scale.dtype == torch.bfloat16
    assert res.pruned_layers
    return res


def test_checkpoint_state_only_round_trip(tmp_path, bf16_state):
    tckpt.save(str(tmp_path / "s"), None, bf16_state.state)
    params, state = tckpt.restore(str(tmp_path / "s"), device="cpu")
    assert params is None
    equal_states(state, bf16_state.state)


def test_checkpoint_params_state_extra_round_trip(tmp_path, setup,
                                                  bf16_state):
    _, _, _, tparams, _ = setup
    extra = {"token": bf16_state.tokens[:, -1], "count": 16, "window": 8,
             "emitted": np.arange(6, dtype=np.int32).reshape(2, 3)}
    tckpt.save(str(tmp_path / "p"), tparams, bf16_state.state, extra=extra)
    params, state, got = tckpt.restore_with_extra(str(tmp_path / "p"),
                                                  device="cpu")
    equal_states(state, bf16_state.state)
    flat = jax.tree_util.tree_leaves_with_path(tparams)
    for path, x in flat:
        y = params
        for k in path:
            y = y[k.key]
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert torch.equal(got["token"], extra["token"])
    assert got["count"] == 16 and got["window"] == 8
    np.testing.assert_array_equal(got["emitted"].numpy(), extra["emitted"])


def test_checkpoint_legacy_payload_defaults(tmp_path, bf16_state):
    """A payload without layer_lengths or quant_bits (pre-cascade,
    pre-profile) restores with the JAX package's defaults: the nominal
    lengths on every layer, 4-bit layers."""
    path = str(tmp_path / "old")
    tckpt.save(path, None, bf16_state.state)
    f = tmp_path / "old" / tckpt.PAYLOAD
    payload = torch.load(f, weights_only=True)
    del payload["state"]["layer_lengths"], payload["state"]["quant_bits"]
    torch.save(payload, f)
    _, state = tckpt.restore(path, device="cpu")
    st = bf16_state.state
    num_layers = st.importance.shape[0]
    assert torch.equal(state.layer_lengths,
                       st.lengths[None].expand(num_layers, -1))
    assert state.layer_lengths.dtype == torch.int32
    assert torch.equal(state.quant_bits,
                       torch.full((num_layers,), 4, dtype=torch.int32))
    assert torch.equal(state.cache.k.full, st.cache.k.full)


def test_jax_orbax_snapshot_converts_to_the_ports_round_trip(tmp_path,
                                                             setup):
    jc, _, jparams, _, prompt = setup
    res = jgen.generate(jparams, jc, jnp.asarray(prompt), 8)
    jckpt.save(str(tmp_path / "j"), None, res.state)
    _, jstate = jckpt.restore(str(tmp_path / "j"))
    from_orbax = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    direct = state_from_jax(jax.tree.map(np.asarray, res.state), "cpu")
    tckpt.save(str(tmp_path / "t"), None, direct)
    _, round_trip = tckpt.restore(str(tmp_path / "t"), device="cpu")
    equal_states(from_orbax, round_trip)


def test_supervised_uninterrupted_matches_jax(tmp_path, setup, jax_runs):
    _, tc, _, tparams, prompt = setup
    got = t_supervised(tparams, tc, prompt, NEW, str(tmp_path / "a"),
                       window=WINDOW, health=lambda: True, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, NEW)
    np.testing.assert_array_equal(got.numpy(), jax_runs["uninterrupted"])
    # the snapshot directory keeps params, the latest snapshot, LATEST
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == [
        "LATEST", "params", f"supervised-{NEW}"]


def test_supervised_killed_window_matches_jax(tmp_path, setup, jax_runs):
    _, tc, _, tparams, prompt = setup
    health, calls = flaky()
    got = t_supervised(tparams, tc, prompt, NEW, str(tmp_path / "b"),
                       window=WINDOW, health=health, device="cpu")
    assert calls["n"] >= 5              # probes ran, failures injected
    np.testing.assert_array_equal(got.numpy(), jax_runs["killed"])
    np.testing.assert_array_equal(got.numpy(), jax_runs["uninterrupted"])


def test_supervised_resume_matches_jax(tmp_path, setup, jax_runs):
    """resume=True restores params and the latest snapshot from the
    directory (the restart after a process dies) and extends the budget
    to the uninterrupted stream."""
    _, tc, _, tparams, prompt = setup
    d = str(tmp_path / "r")
    part = t_supervised(tparams, tc, prompt, 16, d, window=WINDOW,
                        health=lambda: True, device="cpu")
    np.testing.assert_array_equal(part.numpy(),
                                  jax_runs["uninterrupted"][:, :16])
    got = t_supervised(None, tc, prompt, NEW, d, window=WINDOW,
                       health=lambda: True, resume=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), jax_runs["resumed"])
    np.testing.assert_array_equal(got.numpy(), jax_runs["uninterrupted"])


def test_supervised_restart_budget_exhausted(tmp_path, setup):
    _, tc, _, tparams, _ = setup
    with pytest.raises(RuntimeError, match="restarts exhausted"):
        t_supervised(tparams, tc, np.ones((2, 8), np.int32), 8,
                     str(tmp_path / "c"), window=WINDOW,
                     health=lambda: False, max_restarts=2, device="cpu")


def test_supervised_resume_window_mismatch_raises(tmp_path, setup):
    _, tc, _, tparams, prompt = setup
    d = str(tmp_path / "w")
    t_supervised(tparams, tc, prompt, 8, d, window=WINDOW,
                 health=lambda: True, device="cpu")
    with pytest.raises(ValueError, match="snapshot window 8"):
        t_supervised(tparams, tc, prompt, 16, d, window=4,
                     health=lambda: True, resume=True, device="cpu")
