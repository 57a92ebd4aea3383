"""K1's remaining flags in the port vs the JAX package, on the CPU.

K1's plain version against JAX ``fused_decode_attention(interpret=True)``
on the same numpy inputs: the presoftmax importance signal (accumulated
and in delta mode), prob importance in delta mode, and the split-K flags
``append_mask`` (rows that do not append, and an empty shard with no live
token), ``return_row_stats`` (the flash partials m and den) and
``per_row_importance`` under GQA.  Tolerances:

* out, max prob, m, den and importance: atol 2e-5, rtol 1e-4 -- the plain
  version repeats the Pallas body's arithmetic, so only f32 summation
  order differs (as ``tests/test_torch_serving.py``);
* planes and need_requant: exact; scales within one f32 ulp (XLA takes
  amax / 127 as a multiply by the reciprocal); a non-appending row's
  planes and scales keep every byte.

Also ``generate`` on ``ModelConfig.tiny()`` under the reference-parity
flags (``importance_kind="presoftmax"``, ``cascade_accumulate=False``),
against JAX: greedy tokens, layer lengths and requant counts exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz
from spatten_tpu_torch.ops.attention_ref import MASK_VALUE

T = torch.from_numpy
TOL = dict(atol=2e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def k1_inputs(seed, b, hq, hkv, cap, d):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, cap, d)).astype(np.float32)
    x = dict(q=rng.standard_normal((b, hq, 1, d)).astype(np.float32),
             k_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32),
             v_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32),
             imp=rng.uniform(size=(b, hkv, cap)).astype(np.float32))
    jk = jqz.quantize(jnp.asarray(k))
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    tk = tqz.QuantizedKV(*(None if a is None else T(np.array(a)) for a in jk))
    tv = tqz.QuantizedKV(*(None if a is None else T(np.array(a)) for a in jv))
    return x, jk, jv, tk, tv


# name -> (flags, options): b=2, Hkv=2, D=16, capacity 64, v_block 8
CASES = {
    "presoftmax_accumulated": (dict(importance_kind="presoftmax",
                                    accumulate=True, requant=0.3,
                                    v_keep=24), {}),
    "presoftmax_delta": (dict(importance_kind="presoftmax", requant=0.3),
                         {}),
    "prob_delta": (dict(v_keep=24, requant=0.3), {}),
    "append_mask_accumulated": (dict(append_mask=[False, True],
                                     accumulate=True, v_keep=24), {}),
    "append_mask_row_stats": (dict(append_mask=[False, True],
                                   return_row_stats=True, requant=0.3), {}),
    "row_stats_presoftmax": (dict(return_row_stats=True,
                                  importance_kind="presoftmax",
                                  head_mask=[True, True, False, True]), {}),
    "per_row_gqa": (dict(per_row_importance=True, return_row_stats=True,
                         append_mask=[True, False],
                         head_mask=[True, False, True, True]), {}),
    "empty_shard": (dict(append_mask=[False, False], return_row_stats=True,
                         per_row_importance=True, requant=0.3),
                    dict(lengths=[0, 37])),
}


def run_case(flags, opts, seed):
    flags = dict(flags)
    b, hq, hkv, d, cap = 2, 4, 2, 16, 64
    lengths = np.asarray(opts.get("lengths", [50, 31]), np.int32)
    x, jk, jv, tk, tv = k1_inputs(seed, b, hq, hkv, cap, d)
    accumulate = flags.pop("accumulate", False)
    hm = flags.pop("head_mask", None)
    am = flags.pop("append_mask", None)
    kw = dict(sm_scale=0.25, v_block_size=8,
              requant_threshold=flags.pop("requant", 0.0), **flags)
    timp = T(x["imp"].copy()) if accumulate else None
    got = tfd.fused_decode_attention(
        T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), T(lengths),
        importance_in=timp,
        head_mask=None if hm is None else torch.tensor(hm),
        append_mask=None if am is None else torch.tensor(am), **kw)
    want = jfd.fused_decode_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), jnp.asarray(lengths),
        importance_in=jnp.asarray(x["imp"]) if accumulate else None,
        head_mask=None if hm is None else jnp.asarray(hm),
        append_mask=None if am is None else jnp.asarray(am),
        interpret=True, **kw)
    return got, want, timp, lengths, am, (tk, tv), (jk, jv)


@pytest.mark.parametrize("case", list(CASES))
def test_k1_plain_matches_pallas_split_k_flags(case):
    flags, opts = CASES[case]
    got, want, timp, lengths, am, (tk, tv), (jk, jv) = run_case(
        flags, opts, seed=sorted(CASES).index(case))
    assert len(got) == len(want) == (5 if flags.get("return_row_stats")
                                     else 4)
    (tout, tst), (jout, jst) = got[:2], want[:2]
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst.max_prob.numpy(), np.asarray(jst.max_prob),
                               **TOL)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    if flags.get("return_row_stats"):
        (tm, tden), (jm, jden) = got[4], want[4]
        assert tm.shape == tden.shape == (2, 4)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)
        np.testing.assert_allclose(tden.numpy(), np.asarray(jden), **TOL)
    jimp = np.asarray(jst.importance_delta)
    if timp is None:
        # delta mode: the whole plane, zero outside the live columns
        per_row = flags.get("per_row_importance", False)
        assert tst.importance_delta.shape == jimp.shape == (
            2, 4 if per_row else 2, 64)
        np.testing.assert_allclose(tst.importance_delta.numpy(), jimp, **TOL)
        for bi, n in enumerate(lengths):
            assert not tst.importance_delta[bi, :, n:].any()
    else:
        for bi, n in enumerate(lengths):
            np.testing.assert_allclose(timp[bi, :, :n].numpy(),
                                       jimp[bi, :, :n], **TOL)
    # the planes after the call equal JAX's everywhere, and a
    # non-appending row (the empty shard too) keeps every byte it had
    app = np.ones(2, bool) if am is None else np.asarray(am)
    for tq, jq, jq0 in zip((tk, tv), want[2:4], (jk, jv)):
        for name in ("full", "msb", "scale"):
            t, j = getattr(tq, name), getattr(jq, name)
            if t is None:
                continue
            if name == "scale":
                # the appended column's scale is amax / 127, which XLA
                # evaluates as a multiply by the reciprocal: one ulp apart
                # from the IEEE quotient the port and the kernel take
                np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), 1)
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            for bi in np.nonzero(~app)[0]:
                np.testing.assert_array_equal(
                    t[bi].numpy(), np.asarray(getattr(jq0, name))[bi])
    if case == "empty_shard":
        # no live token: zero output, m at MASK_VALUE, den at its 1e-30
        # floor, so a split-K flash weight exp(m - m_g) * den is exactly 0
        tm, tden = got[4]
        assert not tout[0].any()
        assert (tm[0] == MASK_VALUE).all() and (tden[0] == 1e-30).all()
        assert float(torch.exp(tm[0] - tm[1].max()).max() * 1e-30) == 0.0


def parity_tiny(mod):
    """``run_spatten_tpu.py``'s reference-parity signal on a tiny model:
    presoftmax importance, not accumulated, prefill over capacity."""
    return mod.SpAttenConfig(
        model=dataclasses.replace(mod.ModelConfig.tiny(), num_layers=2),
        pruning=mod.PruningConfig(
            start_size=2, important_size=8, recent_size=16, v_block_size=8,
            v_keep_ratio=0.35, importance_kind="presoftmax",
            cascade_accumulate=False),
        quant=mod.QuantConfig(requant_threshold=0.2),
        engine=mod.EngineConfig(cache_capacity=64, prefill_chunk=8,
                                decode_window=8, max_batch_size=2)).validate()


def test_generate_parity_flags_matches_jax():
    jc, tc = parity_tiny(jcfg), parity_tiny(tcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(5),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(5).integers(
        0, jc.model.vocab_size, (2, 70)).astype(np.int32)
    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), 20)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tres = tgen.generate(tparams, tc, T(prompt), 20, device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.layer_lengths.numpy(),
                                  np.asarray(jres.state.layer_lengths))
    assert int(tres.requant_events) == int(jres.requant_events) > 0
