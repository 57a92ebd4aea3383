"""The last public functions of the JAX package given counterparts in the
port, each held against the original on the CPU on the same inputs (made
with numpy): ``engine/kv_cache.init_layer_cache`` and ``prune_layer``,
``pruning/token_pruning.prune_arrays``, ``models/transformer.num_params``,
``ops/quantize.pass1_reference_values``, ``msb_reference_values`` and
``rotate_rows_by_delta``, and ``engine/generate.prefill_scan``; and the
subpackage exports the port's ``engine``, ``pruning`` and ``models``
share with the JAX package's.

Exact: planes, scales, indices, counts and ``prefill_scan``'s integer
state.  Stated tolerances: ``rotate_rows_by_delta``'s int8 planes within
one step (XLA may contract the rotation's multiply-add, so a row's value
can sit on the other side of a rounding), its scales and dequantized rows
within 1e-6 relative and one step; ``prefill_scan``'s logits and
importance within 1e-4, its scales within 1e-5 relative (f32 projections
that the two frameworks sum in different orders).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine import kv_cache as jkv
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import quantize as jqz
from spatten_tpu.ops.rope import rope_table as j_rope_table
from spatten_tpu.pruning import token_pruning as jtp

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine import kv_cache as tkv
from spatten_tpu_torch.engine.state import init_state as t_init_state
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.ops import quantize as tqz
from spatten_tpu_torch.pruning import token_pruning as ttp

torch.set_num_threads(1)


def np_of(t):
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        t = t.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_qkv_equal(tq, jq):
    for f in ("full", "msb", "scale", "lsb2"):
        a, b = np_of(getattr(tq, f)), np_of(getattr(jq, f))
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def qkv_from_np(q):
    return tqz.QuantizedKV(*(None if x is None else torch.from_numpy(
        np.array(x)) for x in q))


@pytest.mark.parametrize("msb, lsb2, dtype", [
    (True, False, "float32"), (True, True, "bfloat16"), (False, False,
                                                         "float32")])
def test_init_layer_cache(msb, lsb2, dtype):
    j = jkv.init_layer_cache(2, 3, 64, 16, with_msb=msb, with_lsb2=lsb2,
                             scale_dtype=jnp.dtype(dtype))
    t = tkv.init_layer_cache(2, 3, 64, 16, with_msb=msb, with_lsb2=lsb2,
                             scale_dtype=getattr(torch, dtype), device="cpu")
    assert t.capacity == j.capacity == 64
    assert_qkv_equal(t.k, j.k)
    assert_qkv_equal(t.v, j.v)


def random_cache(rng, b=2, h=2, c=64, d=16, lsb2=False):
    k = jqz.quantize(jnp.asarray(rng.standard_normal((b, h, c, d)),
                                 jnp.float32), with_lsb2=lsb2)
    v = jqz.quantize(jnp.asarray(rng.standard_normal((b, h, c, d)),
                                 jnp.float32), with_msb=False)
    return jkv.LayerKVCache(k=k, v=v)


@pytest.mark.parametrize("keep, lsb2", [(40, False), (17, True)])
def test_prune_layer(keep, lsb2):
    rng = np.random.default_rng(keep)
    jc = random_cache(rng, lsb2=lsb2)
    idx = np.sort(np.stack([np.stack([
        rng.choice(64, keep, replace=False) for _ in range(2)])
        for _ in range(2)]), axis=-1).astype(np.int32)
    want = jkv.prune_layer(jc, jnp.asarray(idx))
    tc = tkv.LayerKVCache(k=qkv_from_np(jc.k), v=qkv_from_np(jc.v))
    got = tkv.prune_layer(tc, torch.from_numpy(idx))
    assert_qkv_equal(got.k, want.k)
    assert_qkv_equal(got.v, want.v)


def test_prune_arrays():
    rng = np.random.default_rng(5)
    idx = np.sort(rng.permutation(32).reshape(1, 32)[:, :12].repeat(3, 0)
                  .reshape(3, 1, 12) % 32, axis=-1).astype(np.int32)
    a2 = rng.standard_normal((3, 1, 32)).astype(np.float32)
    a3 = rng.integers(-127, 128, (3, 1, 32, 8)).astype(np.int8)
    want = jtp.prune_arrays(jnp.asarray(idx), jnp.asarray(a2),
                            jnp.asarray(a3))
    got = ttp.prune_arrays(torch.from_numpy(idx), torch.from_numpy(a2),
                           torch.from_numpy(a3))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np_of(g), np.asarray(w))
    for mod, arr in ((jtp, jnp.zeros((3, 1, 32, 8, 2))),
                     (ttp, torch.zeros((3, 1, 32, 8, 2)))):
        ix = jnp.asarray(idx) if mod is jtp else torch.from_numpy(idx)
        with pytest.raises(ValueError, match="incompatible"):
            mod.prune_arrays(ix, arr)


@pytest.mark.parametrize("model", ["tiny", "gpt2"])
def test_num_params(model):
    def make(mod):
        if model == "tiny":
            return mod.ModelConfig.tiny()
        return mod.ModelConfig(
            vocab_size=64, hidden_size=32, num_layers=2, num_heads=4,
            num_kv_heads=4, head_dim=8, intermediate_size=64,
            max_position_embeddings=64, model_type="gpt2",
            activation="gelu", tie_word_embeddings=True,
            use_qkv_bias=True, use_mlp_bias=True, layernorm_kind="layernorm",
            use_abs_pos_emb=True)
    jp = jtr.init_params(make(jcfg), jax.random.PRNGKey(0),
                         dtype=jnp.float32)
    tp = ttr.init_params(make(tcfg), 0, dtype=torch.float32, device="cpu")
    assert ttr.num_params(tp) == jtr.num_params(jp) > 0
    assert ttr.num_params(params_from_jax(jax.tree.map(np.asarray, jp),
                                          "cpu")) == jtr.num_params(jp)


@pytest.mark.parametrize("bits", [4, 6, 8])
def test_pass1_reference_values(bits):
    q8 = np.arange(-128, 128, dtype=np.int32).astype(np.int8)
    want = np.asarray(jqz.pass1_reference_values(jnp.asarray(q8), bits))
    got = tqz.pass1_reference_values(torch.from_numpy(q8), bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tqz.msb_reference_values(torch.from_numpy(q8)).numpy(),
        np.asarray(jqz.msb_reference_values(jnp.asarray(q8))))


@pytest.mark.parametrize("lsb2", [False, True])
def test_rotate_rows_by_delta(lsb2):
    rng = np.random.default_rng(7 + lsb2)
    b, h, c, d = 2, 2, 32, 16
    x = rng.standard_normal((b, h, c, d)).astype(np.float32)
    jq = jqz.quantize(jnp.asarray(x), with_lsb2=lsb2)
    delta = -rng.integers(0, 20, (b, h, c)).astype(np.int32)
    cos, sin = (np.array(t, np.float32) for t in j_rope_table(64, d))
    want = jqz.rotate_rows_by_delta(jq, jnp.asarray(delta), jnp.asarray(cos),
                                    jnp.asarray(sin))
    got = tqz.rotate_rows_by_delta(qkv_from_np(jq), torch.from_numpy(delta),
                                   torch.from_numpy(cos),
                                   torch.from_numpy(sin))
    wf, gf = np.asarray(want.full).astype(np.int32), got.full.numpy()
    assert np.abs(gf.astype(np.int32) - wf).max() <= 1
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6)
    step = np.asarray(want.scale)[..., None]
    assert (np.abs(tqz.dequantize_full(got).numpy()
                   - np.asarray(jqz.dequantize_full(want)))
            <= step * 1.000001).all()
    for f in ("msb", "lsb2"):
        assert (getattr(got, f) is None) == (getattr(want, f) is None)
    # delta 0 rotates nothing: the planes come back as they were
    same = tqz.rotate_rows_by_delta(qkv_from_np(jq), torch.zeros_like(
        torch.from_numpy(delta)), torch.from_numpy(cos), torch.from_numpy(sin))
    assert np.abs(same.full.numpy().astype(np.int32)
                  - np.asarray(jq.full).astype(np.int32)).max() <= 1


def scan_cfg(mod):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=16, v_block_size=8),
        quant=mod.QuantConfig(requant_threshold=0.2),
        engine=mod.EngineConfig(cache_capacity=64, prefill_chunk=8,
                                max_batch_size=2)).validate()


@pytest.fixture(scope="module")
def scan_inputs():
    jc = scan_cfg(jcfg)
    jp = jtr.init_params(jc.model, jax.random.PRNGKey(1), dtype=jnp.float32)
    toks = np.random.default_rng(2).integers(
        0, jc.model.vocab_size, (2, 56)).astype(np.int32)
    return jc, jp, toks


def test_prefill_scan_matches_jax(scan_inputs):
    """Two segments of chunks with no prune inside (3 chunks, then 2 more
    after the state has grown): logits within 1e-4, int8 planes, lengths,
    layer lengths and requant count exact, scales within 1e-5 relative,
    importance within 1e-4."""
    jc, jp, toks = scan_inputs
    tc = scan_cfg(tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    js, ts = j_init_state(jc, 2), t_init_state(tc, 2, device="cpu")
    for lo, n in ((0, 3), (24, 2)):
        x = toks[:, lo:lo + 8 * n]
        jl, js = jgen.prefill_scan(jp, jc, js, jnp.asarray(x), nchunks=n)
        tl, ts = tgen.prefill_scan(tp, tc, ts, torch.from_numpy(x).long(),
                                   nchunks=n)
        np.testing.assert_allclose(np_of(tl), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
    jn = jax.tree.map(np.asarray, js)
    np.testing.assert_array_equal(np_of(ts.lengths), jn.lengths)
    np.testing.assert_array_equal(np_of(ts.layer_lengths), jn.layer_lengths)
    assert int(ts.requant_events) == int(jn.requant_events)
    for tq, jq in ((ts.cache.k, jn.cache.k), (ts.cache.v, jn.cache.v)):
        np.testing.assert_array_equal(np_of(tq.full), jq.full)
        np.testing.assert_allclose(np_of(tq.scale), jq.scale, rtol=1e-5)
    np.testing.assert_allclose(np_of(ts.importance), jn.importance,
                               atol=1e-4, rtol=1e-4)


def test_prefill_scan_refuses_a_prune_inside(scan_inputs):
    """Eight chunks of 8 pass capacity 64 at the last: the schedule prunes
    there, so the scan refuses before running any chunk (the caller must
    segment at the prune point, as JAX's ``prefill`` does)."""
    jc, jp, toks = scan_inputs
    tc = scan_cfg(tcfg)
    ts = t_init_state(tc, 2, device="cpu")
    x = torch.from_numpy(np.tile(toks, (1, 2))[:, :72]).long()
    with pytest.raises(ValueError, match="segment the prompt"):
        tgen.prefill_scan({}, tc, ts, x, nchunks=9)
    assert int(ts.lengths.max()) == 0


EXPORTS = {
    "engine": ["Request", "SpAttenServer", "GenerateResult", "decode_step",
               "init_layer_cache", "maybe_prune", "prefill_chunk",
               "write_slot"],
    "pruning": ["select_heads", "head_importance", "importance_from_probs",
                "importance_from_scores", "reduce_to_kv_heads",
                "select_keep_indices", "pruned_length", "prune_arrays"],
    "models": ["hf_loader", "num_params"],
}


@pytest.mark.parametrize("sub, name", [(s, n) for s, ns in EXPORTS.items()
                                       for n in ns])
def test_subpackage_exports(sub, name):
    """Each name the JAX subpackage exports imports from the port's."""
    port = importlib.import_module(f"spatten_tpu_torch.{sub}")
    ref = importlib.import_module(f"spatten_tpu.{sub}")
    assert name in ref.__all__ and name in port.__all__
    assert getattr(port, name) is not None
