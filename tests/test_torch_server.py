"""The port's continuous-batching server (``spatten_tpu_torch.engine.
server``) and its slot scatter, on the CPU.

The five scenarios of ``tests/test_server.py`` run against the port
(server tokens equal ``generate``'s at batch 1; slot recycling and
queueing; EOS release; decode progressing on every tick of a long
admission; chunk-interleaved admission equal to a blocking prefill).
Then the port's server against JAX's ``SpAttenServer`` on the same
requests and weights (``convert.params_from_jax``): generated tokens,
completion order and the free slots exact.  ``state.write_slot`` and
``with_lengths`` exact against JAX's on the same states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import server as jserver
from spatten_tpu.engine import state as jstate
from spatten_tpu.models import transformer as jtr

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax, state_from_jax
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine import state as tstate
from spatten_tpu_torch.engine.server import SpAttenServer
from spatten_tpu_torch.models import transformer

torch.set_num_threads(1)


def cfg_batch(b, mod=tcfg):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=8, v_keep_ratio=0.5,
                                  v_block_size=4),
        quant=mod.QuantConfig(requant_threshold=0.1),
        engine=mod.EngineConfig(max_batch_size=b, cache_capacity=32,
                                prefill_chunk=8),
    ).validate()


def init(seed, cfg=None):
    cfg = cfg or cfg_batch(1)
    return transformer.init_params(cfg.model, seed, dtype=torch.float32,
                                   device="cpu")


def server(params, cfg, **kw):
    return SpAttenServer(params, cfg, device="cpu", **kw)


def test_server_matches_generate():
    cfg = cfg_batch(2)
    params = init(0)
    prompts = [np.array([3, 14, 15, 9, 2], np.int32),
               np.array([27, 18, 28, 18], np.int32),
               np.array([31, 4, 1, 5, 9, 2], np.int32)]
    # individual references (batch 1, no interference)
    refs = [gen.generate(params, cfg_batch(1), p[None], 6,
                         device="cpu").tokens.numpy()[0] for p in prompts]
    # server: 3 requests through 2 slots (forces reuse)
    srv = server(params, cfg)
    ids = [srv.submit(p, max_new_tokens=6) for p in prompts]
    done = srv.run_to_completion()
    assert len(done) == 3
    by_id = {r.request_id: r for r in done}
    for rid, ref in zip(ids, refs):
        np.testing.assert_array_equal(np.array(by_id[rid].generated), ref)


def test_server_slot_recycling_and_queueing():
    cfg = cfg_batch(2)
    srv = server(init(1), cfg)
    for i in range(5):
        srv.submit(np.arange(3 + i) % 255, max_new_tokens=3 + i)
    done = srv.run_to_completion()
    assert len(done) == 5
    for r in done:
        assert len(r.generated) == r.max_new_tokens and r.done
    # all slots free at the end
    assert sorted(srv.free_slots) == [0, 1]
    assert not srv.active and not srv.pending and not srv.admitting


def test_server_eos_release():
    cfg = cfg_batch(1)
    params = init(2)
    # discover the 2nd generated token, then declare it EOS
    probe = server(params, cfg)
    probe.submit(np.array([1, 2, 3], np.int32), max_new_tokens=5)
    full = probe.run_to_completion()[0].generated
    eos = full[1]
    srv = server(params, cfg, eos_token_id=eos)
    srv.submit(np.array([1, 2, 3], np.int32), max_new_tokens=5)
    done = srv.run_to_completion()[0]
    assert done.generated == full[:full.index(eos) + 1]
    assert srv.free_slots == [0]


def test_decode_progresses_during_long_admission():
    """While a long prompt prefills chunk by chunk, already-running
    requests keep decoding every tick."""
    cfg = cfg_batch(2)   # prefill_chunk=8
    srv = server(init(2), cfg)
    srv.submit(np.arange(4) % 255, max_new_tokens=10)
    srv.step()                      # A admitted (1 chunk) + first decode
    a = next(iter(srv.active.values()))
    tokens_before = len(a.generated)
    # request B: long prompt = 3 chunks of prefill
    srv.submit(np.arange(20) % 255, max_new_tokens=2)
    progressed = []
    while srv.admitting or len(progressed) < 3:
        srv.step()
        progressed.append(len(a.generated))
        if len(progressed) > 20:
            break
    assert progressed[:3] == [tokens_before + 1, tokens_before + 2,
                              tokens_before + 3]
    done = srv.run_to_completion()
    assert {len(r.generated) for r in done} == {10, 2}


def test_admission_parity_with_blocking_prefill():
    """Chunk-interleaved admission produces the same tokens as the plain
    generate path (the scatter happens only when prefill completes)."""
    cfg = cfg_batch(2)
    params = init(3)
    long_prompt = (np.arange(19) * 7) % 255
    ref = gen.generate(params, cfg_batch(1), long_prompt[None], 5,
                       device="cpu").tokens.numpy()[0]
    srv = server(params, cfg)
    # keep slot 0 busy so the admission truly interleaves with decode
    srv.submit(np.arange(3) % 255, max_new_tokens=12)
    srv.step()
    rid = srv.submit(long_prompt, max_new_tokens=5)
    done = srv.run_to_completion()
    by_id = {r.request_id: r for r in done}
    np.testing.assert_array_equal(np.array(by_id[rid].generated), ref)


# requests (prompt, max_new_tokens) for the two packages' servers: more
# than the slots, prompts over several chunks and past the capacity (the
# admissions prune), budgets that release out of order
REQUESTS = [((np.arange(n) * m + 5) % 250, new) for n, m, new in
            ((5, 3, 6), (21, 7, 3), (12, 11, 9), (40, 5, 4), (3, 13, 7),
             (17, 2, 5))]


@pytest.mark.parametrize("batch,eos", [(2, None), (3, None), (2, 1)])
def test_server_matches_jax_server(batch, eos):
    jc, tc = cfg_batch(batch, jcfg), cfg_batch(batch)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(4),
                              dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    runs = {}
    for name, srv in (("jax", jserver.SpAttenServer(jparams, jc,
                                                    eos_token_id=eos)),
                      ("port", server(tparams, tc, eos_token_id=eos))):
        ids = [srv.submit(p, new) for p, new in REQUESTS]
        order, ticks = [], 0
        while srv.active or srv.pending or srv.admitting:
            order += [(ticks, r.request_id, tuple(r.generated))
                      for r in srv.step()]
            ticks += 1
        runs[name] = (ids, order, sorted(srv.free_slots), ticks)
    assert runs["port"] == runs["jax"]
    ids, order, free, _ = runs["port"]
    assert free == list(range(batch)) and len(order) == len(REQUESTS)
    if eos is None:
        assert [len(g) for _, _, g in sorted(order, key=lambda x: x[1])] \
            == [new for _, new in REQUESTS]


def states(seed, cfg_j, cfg_t, batch):
    """A JAX state with random leaves and the port's copy of it."""
    rng = np.random.default_rng(seed)
    st = jstate.init_state(cfg_j, batch=batch)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.bool_:
            return jnp.asarray(rng.integers(0, 2, x.shape).astype(bool))
        if np.issubdtype(x.dtype, np.integer):
            info = np.iinfo(x.dtype)
            return jnp.asarray(rng.integers(max(info.min, -100),
                                            min(info.max, 100), x.shape,
                                            dtype=x.dtype))
        return jnp.asarray(rng.standard_normal(x.shape), x.dtype)

    st = jax.tree.map(fill, st)
    return st, state_from_jax(jax.tree.map(np.asarray, st), "cpu")


def assert_states_equal(t, j):
    tl = jax.tree.leaves(jax.tree.map(np.asarray, j))
    pl = [x for x in list(t.cache.k) + list(t.cache.v) + list(t[1:])
          if x is not None]
    assert len(tl) == len(pl)
    for a, b in zip(pl, tl):
        np.testing.assert_array_equal(a.to(torch.float32).numpy()
                                      if a.dtype == torch.bfloat16
                                      else a.numpy(),
                                      np.asarray(b, np.float32)
                                      if b.dtype.name == "bfloat16" else b)


@pytest.mark.parametrize("slot", [0, 2])
def test_write_slot_matches_jax(slot):
    jc = cfg_batch(3, jcfg)
    tc = cfg_batch(3)
    big_j, big_t = states(10 + slot, jc, tc, 3)
    sub_j, sub_t = states(20 + slot, jc, tc, 1)
    want = jstate.write_slot(big_j, sub_j, slot)
    got = tstate.write_slot(big_t, sub_t, slot)
    assert_states_equal(got, want)
    # the head mask is global and stays the arena's
    np.testing.assert_array_equal(got.head_mask.numpy(),
                                  np.asarray(big_j.head_mask))


def test_with_lengths_matches_jax():
    jc, tc = cfg_batch(3, jcfg), cfg_batch(3)
    st_j, st_t = states(30, jc, tc, 3)
    lens = np.array([7, 0, 31], np.int32)
    want = jstate.with_lengths(st_j, lens)
    got = tstate.with_lengths(st_t, lens)
    assert_states_equal(got, want)
    assert got.lengths.dtype == got.layer_lengths.dtype == torch.int32
