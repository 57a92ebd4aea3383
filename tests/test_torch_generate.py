"""The ported slice end to end: JAX ``generate`` vs the port's ``generate``
on ``ModelConfig.tiny()`` with the whole SpAtten pipeline on (cascade
token pruning with prunes in prefill and in decode, local V pruning,
4-bit progressive quantization with requant), on the CPU.

Both run the same f32 weights (JAX ``init_params`` converted to the
port).  Exact: greedy tokens, per-layer lengths and requant events.
Within one int8 step: the cache planes (moved rows are re-rotated with
cos/sin, whose last-ulp rounding may differ between the frameworks).
Within 1e-3: logits."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax, state_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine.state import init_state as t_init_state
from spatten_tpu_torch.ops import quantize as tqz

THRESHOLD = 0.2
PROMPT_LEN, NEW_TOKENS, BATCH = 72, 32, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_dict():
    return dict(
        pruning=dict(start_size=2, important_size=8, recent_size=16,
                     v_block_size=8),
        quant=dict(requant_threshold=THRESHOLD),
        engine=dict(cache_capacity=64, prefill_chunk=8, decode_window=8,
                    max_batch_size=BATCH),
    )


def build(mod):
    d = cfg_dict()
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(**d["pruning"]),
        quant=mod.QuantConfig(**d["quant"]),
        engine=mod.EngineConfig(**d["engine"])).validate()


@pytest.fixture(scope="module")
def runs():
    jc, tc = build(jcfg), build(tcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(
        0, jc.model.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)

    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), NEW_TOKENS)

    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tres = tgen.generate(tparams, tc, torch.from_numpy(prompt), NEW_TOKENS,
                         device="cpu")
    tlast, _, _, _ = tgen.prefill(tparams, tc,
                                  t_init_state(tc, BATCH, device="cpu"),
                                  torch.from_numpy(prompt))

    # replay the JAX decode step by step (same prune points as generate)
    # to read every pass-1 max prob: no seed may hide a requant flip
    jlast, jstate, host_lens = jgen.prefill(
        jparams, jc, j_init_state(jc, BATCH), jnp.asarray(prompt))
    step = jax.jit(jtr.forward, static_argnums=(1,))
    prune = jax.jit(lambda s, layers, n: jgen.maybe_prune(
        jc, s, n, static_layers=layers)[0], static_argnums=(1, 2))
    tok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    toks, maxps = [], []
    for w0 in range(0, NEW_TOKENS, jc.engine.decode_window):
        layers, host_lens = jgen.prune_schedule_step(
            jc, host_lens, jc.engine.decode_window)
        if layers:
            jstate = prune(jstate, layers, jc.engine.decode_window)
        for _ in range(jc.engine.decode_window):
            logits, jstate, aux = step(jparams, jc, jstate, tok[:, None])
            maxps.append(np.asarray(aux.max_probs))
            toks.append(np.asarray(tok))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(np.stack(toks, 1), np.asarray(jres.tokens))
    return jres, tres, np.asarray(jlast), tlast.numpy(), np.stack(maxps)


def test_requant_decisions_clear_of_threshold(runs):
    maxps = runs[4]
    assert np.min(np.abs(maxps - THRESHOLD)) >= 1e-4
    assert (maxps < THRESHOLD).any() and (maxps >= THRESHOLD).any()


def test_tokens_lengths_requants_exact(runs):
    jres, tres = runs[0], runs[1]
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.layer_lengths.numpy(),
                                  np.asarray(jres.state.layer_lengths))
    np.testing.assert_array_equal(tres.state.lengths.numpy(),
                                  np.asarray(jres.state.lengths))
    assert int(tres.requant_events) == int(jres.requant_events) > 0
    # one prune inside prefill, at least one inside decode
    assert len(tres.pruned_layers) >= 2


def test_cache_planes_within_one_step(runs):
    jres, tres = runs[0], runs[1]
    jst, tst = jres.state, tres.state
    lens = np.asarray(jst.layer_lengths)
    for name in ("k", "v"):
        jq, tq = getattr(jst.cache, name), getattr(tst.cache, name)
        jfull, tfull = np.asarray(jq.full), tq.full.numpy()
        jsc, tsc = np.asarray(jq.scale), tq.scale.numpy()
        for l in range(lens.shape[0]):
            for b in range(lens.shape[1]):
                n = lens[l, b]
                diff = np.abs(tfull[l, b, :n].astype(np.int32)
                              - jfull[l, b, :n].astype(np.int32))
                assert diff.max() <= 1, (name, l, b)
                np.testing.assert_allclose(tsc[l, b, :, :n],
                                           jsc[l, b, :, :n], rtol=1e-4)
    # the packed plane is the nibble image of the port's own full plane
    for l in range(lens.shape[0]):
        for b in range(lens.shape[1]):
            n = lens[l, b]
            nib = tqz.unpack_msb(tst.cache.k.msb[l, b]).numpy()[:n]
            want = (tst.cache.k.full[l, b, :n].numpy().astype(np.int32)
                    >> 4)
            np.testing.assert_array_equal(nib, want)


def test_prefill_logits(runs):
    jlast, tlast = runs[2], runs[3]
    np.testing.assert_allclose(tlast, jlast, atol=1e-3, rtol=0)


def test_state_conversion_roundtrip():
    jc, tc = build(jcfg), build(tcfg)
    jst = j_init_state(jc, BATCH)
    tst = state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    fresh = t_init_state(tc, BATCH, device="cpu")
    for a, b in zip(jax.tree.leaves(tst), jax.tree.leaves(fresh)):
        assert torch.equal(a, b)


def test_maybe_prune_ragged_lengths_matches_jax():
    """Ragged lengths (one sequence overflows, one does not): JAX's
    dynamic per-layer conds vs the port's host-checked triggers."""
    jc, tc = build(jcfg), build(tcfg)
    rng = np.random.default_rng(3)
    jst = j_init_state(jc, BATCH)
    L, H, C, D = 2, 2, 64, 8
    kx = rng.standard_normal((L, BATCH, H, C, D)).astype(np.float32)
    vx = rng.standard_normal((L, BATCH, H, C, D)).astype(np.float32)
    kq = jax.vmap(lambda x: jqz.quantize(x))(jnp.asarray(kx))
    vq = jax.vmap(lambda x: jqz.quantize(x, with_msb=False))(jnp.asarray(vx))
    lengths = np.array([[60, 30], [60, 30]], np.int32)
    jst = jst._replace(
        cache=jst.cache._replace(k=kq, v=vq),
        importance=jnp.asarray(rng.uniform(size=(L, BATCH, H, C)),
                               jnp.float32),
        lengths=jnp.asarray(lengths[0]), layer_lengths=jnp.asarray(lengths))
    tst = state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    jout, jtrig = jgen.maybe_prune(jc, jst, 8)
    tout, ttrig = tgen.maybe_prune(tc, tst, 8)
    np.testing.assert_array_equal(ttrig.numpy(), np.asarray(jtrig))
    assert ttrig.tolist() == [True, False]
    np.testing.assert_array_equal(tout.layer_lengths.numpy(),
                                  np.asarray(jout.layer_lengths))
    for l in range(L):
        for b in range(BATCH):
            n = int(lengths[l, b]) if b else int(tout.layer_lengths[l, b])
            for name in ("k", "v"):
                t = getattr(tout.cache, name).full[l, b, :n].numpy()
                j = np.asarray(getattr(jout.cache, name).full)[l, b, :n]
                assert np.abs(t.astype(int) - j.astype(int)).max() <= 1
            np.testing.assert_allclose(tout.importance[l, b, :, :n].numpy(),
                                       np.asarray(jout.importance)[l, b, :, :n])
