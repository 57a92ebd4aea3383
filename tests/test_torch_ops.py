"""Port vs JAX: RoPE, the reference and prefill attention, keep selection
and the static prune schedule, and prune compaction, on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import kv_cache as jkv
from spatten_tpu.engine import generate as jgen
from spatten_tpu.ops import attention_ref as jref
from spatten_tpu.ops import prefill_attention as jpre
from spatten_tpu.ops import quantize as jqz
from spatten_tpu.ops import rope as jrope
from spatten_tpu.pruning import compact as jcompact
from spatten_tpu.pruning import token_pruning as jtp

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine import kv_cache as tkv
from spatten_tpu_torch.engine.sampling import SamplingParams, sample_token
from spatten_tpu_torch.ops import attention_ref as tref
from spatten_tpu_torch.ops import prefill_attention as tpre
from spatten_tpu_torch.ops import quantize as tqz
from spatten_tpu_torch.ops import rope as trope
from spatten_tpu_torch.pruning import compact as tcompact
from spatten_tpu_torch.pruning import token_pruning as ttp

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_rope_table_and_apply():
    tc, ts = trope.rope_table(64, 16, device="cpu")
    jc, js = jrope.rope_table(64, 16)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=2e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=2e-6)
    x = normal((2, 3, 64, 16), 0)
    np.testing.assert_allclose(
        trope.apply_rope_at_cache_positions(T(x), tc, ts).numpy(),
        np.asarray(jrope.apply_rope_at_cache_positions(jnp.asarray(x), jc,
                                                       js)), atol=1e-5)


@pytest.mark.parametrize("tied", [False, True])
def test_select_keep_indices_budgeted_exact(tied):
    """Exact keep sets, including importance ties (never-attended tokens
    all sit at 0: jax.lax.top_k breaks ties toward the lower index)."""
    L, B, H, C = 3, 2, 2, 64
    imp = np.random.default_rng(1).uniform(size=(L, B, H, C)
                                           ).astype(np.float32)
    if tied:
        imp[..., 10:50] = np.round(imp[..., 10:50] * 3) / 3   # many ties
        imp[0, 0, 0, :] = 0.0
    lengths = np.array([[60, 64], [40, 64], [30, 12]], np.int32)
    budget = np.array([8, 5, 3], np.int32)
    want = jtp.select_keep_indices_budgeted(
        jnp.asarray(imp), jnp.asarray(lengths), 2, jnp.asarray(budget), 8,
        16, 0)
    got = ttp.select_keep_indices_budgeted(T(imp), T(lengths), 2, T(budget),
                                           8, 16, 0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("cap,decay", [(1024, 1.0), (8192, 0.7)])
def test_static_schedule_matches(cap, decay):
    def cfg(mod):
        return mod.SpAttenConfig(
            model=dataclasses.replace(mod.ModelConfig.tiny(), num_layers=6),
            pruning=mod.PruningConfig(start_size=4, important_size=384,
                                      recent_size=384,
                                      cascade_layer_decay=decay),
            engine=mod.EngineConfig(cache_capacity=cap))
    jc, tc = cfg(jcfg), cfg(tcfg)
    assert ttp.layer_capacities(tc) == jtp.layer_capacities(jc)
    assert ttp.layer_capacity_groups(tc) == jtp.layer_capacity_groups(jc)
    assert ttp.layer_keep_max_static(tc.pruning, 6) == \
        jtp.layer_keep_max_static(jc.pruning, 6)
    lens_t = lens_j = [0] * 6
    for n in [128] * 9 + [64] * 200:
        lt, lens_t = tgen.prune_schedule_step(tc, lens_t, n)
        lj, lens_j = jgen.prune_schedule_step(jc, lens_j, n)
        assert lt == lj and lens_t == lens_j


def attention_inputs(s, seed=0, b=2, hq=4, hkv=2, cap=64, d=16):
    q = normal((b, hq, s, d), seed)
    k = normal((b, hkv, cap, d), seed + 1)
    v = normal((b, hkv, cap, d), seed + 2)
    lengths = np.array([50, 23], np.int32)
    qpos = (lengths[:, None] - s + np.arange(s)[None]).astype(np.int32)
    return q, k, v, lengths, qpos


@pytest.mark.parametrize("kw", [
    dict(requant_threshold=0.15, v_keep=24, v_block_size=8),
    dict(quant_enabled=False, v_keep=0),
    dict(importance_kind="presoftmax",
         head_mask=np.array([True, False, True, True])),
])
def test_reference_attention(kw):
    q, k, v, lengths, qpos = attention_inputs(3)
    jk, jv = jqz.quantize(jnp.asarray(k)), jqz.quantize(jnp.asarray(v))
    tk, tv = tqz.quantize(T(k)), tqz.quantize(T(v))
    jc, js = jrope.rope_table(64, 16)
    tc, ts = trope.rope_table(64, 16, device="cpu")
    tkw = dict(kw)
    if "head_mask" in kw:
        tkw["head_mask"] = T(kw["head_mask"])
        kw = dict(kw, head_mask=jnp.asarray(kw["head_mask"]))
    jo, jst = jref.spatten_attention_reference(
        jnp.asarray(q), jk, jv, jc, js, jnp.asarray(lengths),
        jnp.asarray(qpos), sm_scale=0.25, **kw)
    to, tst = tref.spatten_attention_reference(
        T(q), tk, tv, tc, ts, T(lengths), T(qpos), sm_scale=0.25, **tkw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tst.max_prob.numpy(),
                               np.asarray(jst.max_prob), atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    np.testing.assert_allclose(tst.importance_delta.numpy(),
                               np.asarray(jst.importance_delta), atol=2e-4,
                               rtol=1e-4)


def test_prefill_attention_matches_jax():
    q, k, v, lengths, qpos = attention_inputs(8, seed=3)
    jk, jv = jqz.quantize(jnp.asarray(k)), jqz.quantize(jnp.asarray(v))
    tk, tv = tqz.quantize(T(k)), tqz.quantize(T(v))
    kw = dict(sm_scale=0.25, requant_threshold=0.2, v_keep=16,
              v_block_size=8, use_rope=False)
    jo, jst = jpre.prefill_attention(
        jnp.asarray(q), jk, jv, None, None, jnp.asarray(lengths),
        jnp.asarray(qpos), block_size=16, **kw)
    to, tst = tpre.prefill_attention(T(q), tk, tv, None, None, T(lengths),
                                     T(qpos), **kw)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    np.testing.assert_allclose(tst.importance_delta.numpy(),
                               np.asarray(jst.importance_delta), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("use_kernel_path", [False, True])
def test_compact_layer_matches_jax(use_kernel_path):
    """compact_layer vs JAX's use_gather_kernel=False path.  The port's K2
    path (the kernel's plain version on the CPU) must agree on every live
    row; the gather path also on the dead ones."""
    b, h, cap, d = 2, 2, 64, 16
    kx, vx = normal((b, h, cap, d), 7), normal((b, h, cap, d), 8)
    imp = np.random.default_rng(9).uniform(size=(b, h, cap)
                                           ).astype(np.float32)
    lengths = np.array([60, 50], np.int32)
    triggered = np.array([True, False])
    keep_idx, keep_count = jtp.select_keep_indices_budgeted(
        jnp.asarray(imp)[None], jnp.asarray(lengths)[None], 2,
        jnp.asarray([8], jnp.int32), 8, 16, 0)
    keep_idx, keep_count = np.array(keep_idx[0]), np.array(keep_count[0])
    keep_max = keep_idx.shape[-1]
    keep_idx[1] = np.arange(keep_max)                # untriggered: identity
    keep_count[1] = keep_max
    kw = dict(rotate_k=True, triggered=triggered, keep_count=keep_count,
              lengths=lengths)
    jcache = jkv.LayerKVCache(k=jqz.quantize(jnp.asarray(kx)),
                              v=jqz.quantize(jnp.asarray(vx)))
    jout, jimp = jcompact.compact_layer(
        jcache, jnp.asarray(imp), jnp.asarray(keep_idx),
        use_gather_kernel=False,
        **{k: jnp.asarray(v) for k, v in kw.items() if k != "rotate_k"},
        rotate_k=True)
    tcache = tkv.LayerKVCache(k=tqz.quantize(T(kx)), v=tqz.quantize(T(vx)))
    timp = T(imp.copy())
    tcompact.compact_layer(
        tcache, timp, T(keep_idx), use_gather_kernel=use_kernel_path,
        **{k: T(v) for k, v in kw.items() if k != "rotate_k"}, rotate_k=True)
    live = [int(keep_count[0]), cap]       # untriggered row: all untouched
    for bi in range(b):
        n = live[bi] if use_kernel_path else cap
        for name in ("k", "v"):
            jq, tq = getattr(jout, name), getattr(tcache, name)
            diff = np.abs(tq.full[bi, :n].numpy().astype(np.int32)
                          - np.asarray(jq.full)[bi, :n].astype(np.int32))
            assert diff.max() <= 1, (name, bi)
            np.testing.assert_allclose(tq.scale[bi, :, :n].numpy(),
                                       np.asarray(jq.scale)[bi, :, :n],
                                       rtol=1e-5)
        np.testing.assert_array_equal(timp[bi, :, :n].numpy(),
                                      np.asarray(jimp)[bi, :, :n])
    # untriggered sequence: bit-exact no-op
    np.testing.assert_array_equal(tcache.k.full[1].numpy(),
                                  np.asarray(jcache.k.full)[1])
    # the packed plane is the nibble image of the compacted full plane
    np.testing.assert_array_equal(
        tqz.unpack_msb(tcache.k.msb).numpy(),
        tcache.k.full.numpy().astype(np.int32) >> 4)


def test_weight_quant_matches_jax():
    """Per-output-channel int8 weights and the matmul/lookup helpers."""
    from spatten_tpu.models import transformer as jtr
    from spatten_tpu.models import weight_quant as jwq
    from spatten_tpu_torch.convert import params_from_jax
    from spatten_tpu_torch.models import weight_quant as twq
    jp = jtr.init_params(jcfg.ModelConfig.tiny(), jax.random.PRNGKey(1),
                         dtype=jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    jq, tq = jwq.quantize_params(jp), twq.quantize_params(tp)
    for name in ("wq", "w_down"):
        np.testing.assert_array_equal(tq["layers"][name]["qw"].numpy(),
                                      np.asarray(jq["layers"][name]["qw"]))
    x = normal((3, 32), 10)
    w, e = tq["layers"]["wq"], tq["embed"]
    w = {k: v[0] for k, v in w.items()}
    jw = {k: v[0] for k, v in jq["layers"]["wq"].items()}
    np.testing.assert_allclose(twq.matmul(T(x), w).numpy(),
                               np.asarray(jwq.matmul(jnp.asarray(x), jw)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        twq.matmul_t(T(x), e).numpy(),
        np.asarray(jwq.matmul_t(jnp.asarray(x), jq["embed"])),
        rtol=1e-5, atol=1e-5)
    idx = np.array([[3, 0, 255]])
    np.testing.assert_allclose(
        twq.take_rows(e, T(idx)).numpy(),
        np.asarray(jwq.take_rows(jq["embed"], jnp.asarray(idx))), rtol=1e-6)


def test_greedy_sampling_first_max():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, -1.0, 3.0, 3.0]])
    assert sample_token(logits, None, SamplingParams()).tolist() == [1, 0]
    g = torch.Generator().manual_seed(0)
    out = sample_token(logits, g, SamplingParams(temperature=1.0, top_k=2))
    assert out.tolist()[0] in (1, 2) and out.tolist()[1] in (0, 2, 3)
