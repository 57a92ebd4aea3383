"""Head pruning in the port vs the JAX package, on the CPU.

``select_heads`` (ties included), ``head_importance_from_state``,
``update_head_mask``, ``compact_head_params`` and the importance
reductions are exact against JAX: they are selections and f32 sums of
the same values.  ``generate`` on ``ModelConfig.tiny()`` with on-the-fly
head pruning (``head_keep=1``, interval 4, f32 metadata) is exact in its
greedy tokens, head masks, layer lengths and requant counts, as is the
permanent mode with compacted projections.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine import policy as jpol
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.models.weight_quant import quantize_params as j_quantize
from spatten_tpu.pruning import head_pruning as jhp
from spatten_tpu.pruning import importance as jimp

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax, state_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine import policy as tpol
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.pruning import head_pruning as thp
from spatten_tpu_torch.pruning import importance as timp

T = torch.from_numpy
# The prompt overflows the capacity (64), so prefill prunes: before any
# prune every head's accumulated mass is exactly its number of queries (a
# tie that f32 rounding decides differently in the two frameworks).
PROMPT_LEN, NEW_TOKENS, BATCH = 72, 24, 2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("keep", [1, 2, 3, 5])
def test_select_heads_ties(keep):
    """Many exact ties (values on a coarse bf16-like grid): the lower
    index wins, as with ``jax.lax.top_k``."""
    rng = np.random.default_rng(keep)
    imp = (rng.integers(0, 4, (6, 5)) * 0.25).astype(np.float32)
    imp[0] = 0.5                               # a row of all-equal heads
    want = np.asarray(jhp.select_heads(jnp.asarray(imp), keep))
    got = thp.select_heads(T(imp), keep).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got.sum(-1) == min(keep, 5)).all()


def test_importance_reductions():
    rng = np.random.default_rng(0)
    p = rng.uniform(size=(2, 4, 3, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        timp.importance_from_probs(T(p)).numpy(),
        np.asarray(jimp.importance_from_probs(jnp.asarray(p))))
    np.testing.assert_array_equal(
        timp.importance_from_scores(T(p)).numpy(),
        np.asarray(jimp.importance_from_scores(jnp.asarray(p))))
    np.testing.assert_array_equal(
        timp.reduce_to_kv_heads(T(p), 2).numpy(),
        np.asarray(jimp.reduce_to_kv_heads(jnp.asarray(p), 2)))
    tok = rng.uniform(size=(2, 4, 16)).astype(np.float32)
    # a sum of 16 f32 values: another order, within rounding
    np.testing.assert_allclose(
        thp.head_importance(T(tok), torch.tensor(9)).numpy(),
        np.asarray(jhp.head_importance(jnp.asarray(tok), 9)), rtol=1e-6)


def test_apply_head_mask_and_quant_profile():
    rng = np.random.default_rng(2)
    out = rng.standard_normal((2, 4, 1, 8)).astype(np.float32)
    hm = np.array([[True, True, False, False], [False, True, True, True]])
    np.testing.assert_array_equal(
        thp.apply_head_mask(T(out), T(hm)).numpy(),
        np.asarray(jhp.apply_head_mask(jnp.asarray(out), jnp.asarray(hm))))
    for bits in (None, (4, 6)):
        jc, tc = (dataclasses.replace(
            hp_cfg(mod), quant=mod.QuantConfig(layer_bits=bits))
            for mod in (jcfg, tcfg))
        assert tpol.quant_profile(tc) == jpol.quant_profile(jc)
    assert tpol.quant_profile(hp_cfg(tcfg).__class__(
        quant=tcfg.QuantConfig(enabled=False))) == jpol.quant_profile(
        jcfg.SpAttenConfig(quant=jcfg.QuantConfig(enabled=False)))


def hp_cfg(mod, interval=4, compact=False, importance_dtype="float32",
           batch=BATCH, num_kv_heads=None):
    model = mod.ModelConfig.tiny()
    if num_kv_heads:
        model = dataclasses.replace(model, num_heads=num_kv_heads * 2,
                                    num_kv_heads=num_kv_heads)
    return mod.SpAttenConfig(
        model=model,
        pruning=mod.PruningConfig(
            start_size=2, important_size=8, recent_size=16, v_block_size=8,
            enable_head_pruning=True, head_keep=1,
            head_update_interval=interval, importance_dtype=importance_dtype),
        quant=mod.QuantConfig(requant_threshold=0.2),
        engine=mod.EngineConfig(cache_capacity=64, prefill_chunk=8,
                                decode_window=8, max_batch_size=batch,
                                compact_pruned_heads=compact)).validate()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_importance_and_mask_match_jax(dtype):
    """Ragged per-layer lengths: the policy masks with ``state.lengths``
    (the max over layers), dead columns of the shorter layers included."""
    jc, tc = (hp_cfg(m, importance_dtype=dtype, num_kv_heads=4)
              for m in (jcfg, tcfg))
    rng = np.random.default_rng(1)
    jst = j_init_state(jc, BATCH)
    # coarse values give exact ties between heads
    imp = (rng.integers(0, 3, jst.importance.shape) * 0.5).astype(np.float32)
    lengths = np.array([[50, 33], [20, 12]], np.int32)        # [L, B]
    jst = jst._replace(importance=jnp.asarray(imp, jst.importance.dtype),
                       layer_lengths=jnp.asarray(lengths),
                       lengths=jnp.asarray(lengths.max(0)))
    tst = state_from_jax(jax.tree.map(np.asarray, jst), "cpu")
    np.testing.assert_array_equal(
        tpol.head_importance_from_state(tst).numpy(),
        np.asarray(jpol.head_importance_from_state(jst)))
    np.testing.assert_array_equal(
        tpol.update_head_mask(tc, tst).head_mask.numpy(),
        np.asarray(jpol.update_head_mask(jc, jst).head_mask))


@pytest.mark.parametrize("quantized", [False, True])
def test_compact_head_params_matches_jax(quantized):
    jc, tc = hp_cfg(jcfg, num_kv_heads=4), hp_cfg(tcfg, num_kv_heads=4)
    jp = jtr.init_params(jc.model, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quantized:
        jp = j_quantize(jp)
    mask = np.zeros((2, 8), bool)
    mask[0, 2:4] = True            # layer 0 keeps kv group 1
    mask[1, 6:8] = True            # layer 1 keeps kv group 3
    jhc = jtr.compact_head_params(jp, jc, jnp.asarray(mask))
    thc = ttr.compact_head_params(
        params_from_jax(jax.tree.map(np.asarray, jp), "cpu"), tc, T(mask))
    for key in ("kept_q", "kept_kv"):
        np.testing.assert_array_equal(thc[key].numpy(), np.asarray(jhc[key]))
    jl = jax.tree.map(np.asarray, jhc["layers"])
    tl = jax.tree.map(lambda t: t.numpy(), thc["layers"])
    assert jax.tree.structure(jl) == jax.tree.structure(tl)
    for a, b in zip(jax.tree.leaves(tl), jax.tree.leaves(jl)):
        np.testing.assert_array_equal(a, b)


def run_generate(jc, tc, seed=0):
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(seed),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(seed).integers(
        0, jc.model.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), NEW_TOKENS)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tres = tgen.generate(tparams, tc, T(prompt), NEW_TOKENS, device="cpu")
    return jres, tres


def test_generate_on_the_fly_head_pruning_exact():
    jres, tres = run_generate(hp_cfg(jcfg), hp_cfg(tcfg))
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.head_mask.numpy(),
                                  np.asarray(jres.state.head_mask))
    np.testing.assert_array_equal(tres.state.layer_lengths.numpy(),
                                  np.asarray(jres.state.layer_lengths))
    assert int(tres.requant_events) == int(jres.requant_events)
    # one kv group of two alive per layer; the mask was derived after
    # prefill and at each of the three window boundaries (interval 4 <
    # window 8 fires at every boundary)
    assert (tres.state.head_mask.numpy().reshape(2, 2, 2).any(-1).sum(-1)
            == 1).all()
    assert len(tres.head_mask_updates) == 1 + NEW_TOKENS // 8


def test_generate_permanent_compacted_heads_exact():
    jres, tres = run_generate(hp_cfg(jcfg, interval=0, compact=True),
                              hp_cfg(tcfg, interval=0, compact=True), seed=1)
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.head_mask.numpy(),
                                  np.asarray(jres.state.head_mask))
    assert len(tres.head_mask_updates) == 1


def test_head_mask_clock():
    c = hp_cfg(tcfg, interval=32)
    assert [tgen.head_mask_due(c, clock, 8) for clock in (64, 71, 72, 95)] \
        == [True, True, False, False]
    assert not tgen.head_mask_due(hp_cfg(tcfg, interval=0), 64, 8)
