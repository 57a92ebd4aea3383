"""The port's split-K decode on n CPU shards vs ``spatten_tpu.parallel.
split_k`` on the 8-device CPU mesh that ``tests/conftest.py`` sets up.

The same numpy inputs go to both.  The port's mesh is an explicit list of
devices (here n times the CPU); its sharded cache is a list of per-shard
planes, joined back to the JAX package's global layout for comparison.
Tolerances are the JAX split-K tests' own: outputs and importance atol
3e-5, rtol 1e-4 (f32 sums in another order, and the flash recombination
on top); planes, keep sets and local lengths exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu.parallel import split_k as jsk
from spatten_tpu.pruning import token_pruning as jtp

from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.parallel import split_k as tsk
from spatten_tpu_torch.pruning import token_pruning as ttp

T = torch.from_numpy
TOL = dict(atol=3e-5, rtol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def meshes(n):
    if jax.device_count() < n:
        pytest.skip("needs the virtual device mesh of tests/conftest.py")
    return jsk.make_kv_mesh(n), tsk.make_kv_mesh(["cpu"] * n)


def assert_kv_equal(tshards, jq, appended=False):
    """Per-shard port planes, joined, equal a JAX global QuantizedKV.
    ``appended``: a decode step wrote a new row, whose scale is amax / 127,
    which XLA evaluates as a multiply by the reciprocal -- one ulp from
    the IEEE quotient the port and the kernel take."""
    got = tsk.join_kv(tshards)
    for name in ("full", "msb", "scale", "lsb2"):
        t, j = getattr(got, name), getattr(jq, name)
        assert (t is None) == (j is None), name
        if t is not None and name == "scale" and appended:
            np.testing.assert_array_max_ulp(t.numpy(), np.asarray(j), 1)
        elif t is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)


@pytest.mark.parametrize("num_coming", [0, 3])
def test_select_keep_indices_matches_jax(num_coming):
    """Global keep selection, exact: importance on a coarse grid (many
    ties, broken toward the lower index) and per-sequence lengths."""
    rng = np.random.default_rng(num_coming)
    imp = rng.integers(0, 4, (3, 2, 96)).astype(np.float32)
    lengths = np.array([[96], [70], [41]], np.int32)
    want = jtp.select_keep_indices(jnp.asarray(imp), jnp.asarray(lengths), 4,
                                   20, 12, num_coming)
    got = ttp.select_keep_indices(T(imp), T(lengths), 4, 20, 12, num_coming)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,lengths", [(2, [50, 23, 64]), (4, [8, 9, 32])])
def test_split_k_decode_matches_jax(n, lengths):
    """Dense flash partials, lengths on and inside shard boundaries."""
    jmesh, tmesh = meshes(n)
    b, h, c, d = 3, 2, 32 * n // 2, 8
    rng = np.random.default_rng(n)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((b, h, d), (b, h, c, d), (b, h, c, d)))
    lens = np.asarray(lengths, np.int32)
    want = jsk.split_k_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(lens), jmesh, sm_scale=0.3)
    got = tsk.split_k_decode(T(q), tsk.shard_tokens(T(k), tmesh, -2),
                             tsk.shard_tokens(T(v), tmesh, -2), T(lens),
                             tmesh, sm_scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(
        tsk.reference_decode(T(q), T(k), T(v), T(lens), 0.3).numpy(),
        np.asarray(want), atol=1e-5, rtol=1e-5)


def fused_inputs(seed, n, b, hq, hkv, d, cl):
    rng = np.random.default_rng(seed)
    cap = n * cl
    x = dict(q=rng.standard_normal((b, hq, 1, d)),
             k=rng.standard_normal((b, hkv, cap, d)),
             v=rng.standard_normal((b, hkv, cap, d)),
             k_new=rng.standard_normal((b, hkv, 1, d)),
             v_new=rng.standard_normal((b, hkv, 1, d)),
             imp=rng.uniform(size=(b, hkv, cap)))
    return {k: a.astype(np.float32) for k, a in x.items()}


def run_fused(x, n, local, jmesh, tmesh, jk, jv, tk, tv, **kw):
    """One split-K step in both packages; the port's shards update in
    place."""
    timp = tsk.shard_tokens(T(x["imp"].copy()), tmesh, -1)
    want = jsk.split_k_decode_fused(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), jnp.asarray(local), jmesh, sm_scale=0.18,
        importance_in=jnp.asarray(x["imp"]), interpret=True, **kw)
    got = tsk.split_k_decode_fused(
        T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), T(local), tmesh,
        sm_scale=0.18, importance_in=timp, **kw)
    return got, want


@pytest.mark.parametrize("n,hq,hkv", [(2, 2, 2), (4, 4, 2)])
def test_split_k_fused_matches_jax(n, hq, hkv):
    """K1 per shard: owner-only append, exact recombination, importance
    rescaled per row (MHA, and GQA through per_row_importance); shards
    0..n-2 full, the owner partly live."""
    jmesh, tmesh = meshes(n)
    b, d, cl = 2, 32, 64
    x = fused_inputs(7 + n, n, b, hq, hkv, d, cl)
    jk = jsk.quantize_sharded(jnp.asarray(x["k"]), n, with_msb=True)
    jv = jsk.quantize_sharded(jnp.asarray(x["v"]), n, with_msb=False)
    tk = tsk.quantize_sharded(T(x["k"]), tmesh, with_msb=True)
    tv = tsk.quantize_sharded(T(x["v"]), tmesh, with_msb=False)
    assert_kv_equal(tk, jk)
    assert_kv_equal(tv, jv)
    own = np.array([20, 41], np.int32)
    local = np.concatenate([np.full((n - 1, b), cl, np.int32), own[None]])
    before = [s.full.clone() for s in tk]
    (tout, tk, tv, timp, tmp, tneed), (jout, jk2, jv2, jimp, jmp, jneed) = \
        run_fused(x, n, local, jmesh, tmesh, jk, jv, tk, tv,
                  quant_enabled=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert_kv_equal(tk, jk2, appended=True)
    assert_kv_equal(tv, jv2, appended=True)
    for i in range(n - 1):                      # only the owner appended
        assert torch.equal(tk[i].full, before[i])
    imp = tsk.join_tokens(timp).numpy()
    for bb in range(b):
        live = (n - 1) * cl + int(own[bb])
        np.testing.assert_allclose(imp[bb, :, :live],
                                   np.asarray(jimp)[bb, :, :live], **TOL)
    np.testing.assert_allclose(tmp.numpy(), np.asarray(jmp), **TOL)
    np.testing.assert_array_equal(tneed.numpy(), np.asarray(jneed))


def test_split_k_prune_and_continue_matches_jax():
    """Decode, prune (global selection, gather, shard-local repack) and
    decode again over the pruned shards: shard 2 holds one live token (the
    new one) and shard 3 none."""
    n = 4
    jmesh, tmesh = meshes(n)
    b, h, d, cl = 2, 2, 32, 64
    cap = n * cl
    x = fused_inputs(21, n, b, h, h, d, cl)
    jk = jsk.quantize_sharded(jnp.asarray(x["k"]), n)
    jv = jsk.quantize_sharded(jnp.asarray(x["v"]), n, with_msb=False)
    tk = tsk.quantize_sharded(T(x["k"]), tmesh)
    tv = tsk.quantize_sharded(T(x["v"]), tmesh, with_msb=False)
    glob0 = np.full((b,), cap - 2, np.int32)
    local0 = np.stack([np.clip(glob0 - i * cl, 0, cl) for i in range(n)])
    start, important, recent = 4, 96, 28
    keep_total = start + important + recent
    jk2, jv2, jimp2, jlocal2 = jsk.split_k_prune(
        jk, jv, jnp.asarray(x["imp"]), jnp.asarray(local0), jmesh,
        start_size=start, important_size=important, recent_size=recent)
    tk2, tv2, timp2, tlocal2 = tsk.split_k_prune(
        tk, tv, tsk.shard_tokens(T(x["imp"]), tmesh, -1), T(local0), tmesh,
        start_size=start, important_size=important, recent_size=recent)
    assert_kv_equal(tk2, jk2)
    assert_kv_equal(tv2, jv2)
    np.testing.assert_array_equal(tsk.join_tokens(timp2).numpy(),
                                  np.asarray(jimp2))
    np.testing.assert_array_equal(tlocal2.numpy(), np.asarray(jlocal2))
    assert tlocal2[:, 0].tolist() == [64, 64, 0, 0]

    local3 = tlocal2.numpy().copy()
    local3[keep_total // cl] += 1               # the append slot's owner
    assert local3[:, 0].tolist() == [64, 64, 1, 0]
    x["imp"] = np.asarray(jimp2)
    (tout, tk3, _, timp3, _, _), (jout, jk3, _, jimp3, _, _) = run_fused(
        x, n, local3, jmesh, tmesh, jk2, jv2, tk2, tv2, quant_enabled=True,
        requant_threshold=0.2)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    assert_kv_equal(tk3, jk3, appended=True)
    live = keep_total + 1
    np.testing.assert_allclose(tsk.join_tokens(timp3).numpy()[..., :live],
                               np.asarray(jimp3)[..., :live], **TOL)


def test_split_k_prune_trigger_gating_matches_jax():
    """Untriggered sequences keep every byte and their local lengths; the
    triggered one compacts, with moved keys re-rotated (rotate_k)."""
    n = 4
    jmesh, tmesh = meshes(n)
    b, h, d, cl = 2, 2, 32, 64
    cap = n * cl
    x = fused_inputs(31, n, b, h, h, d, cl)
    jk = jsk.quantize_sharded(jnp.asarray(x["k"]), n)
    tk = tsk.quantize_sharded(T(x["k"]), tmesh)
    glob0 = np.array([cap - 2, 40], np.int32)
    local0 = np.stack([np.clip(glob0 - i * cl, 0, cl) for i in range(n)])
    kw = dict(start_size=4, important_size=96, recent_size=28)
    trig = np.array([True, False])
    jk2, _, jimp2, jlocal2 = jsk.split_k_prune(
        jk, jk, jnp.asarray(x["imp"]), jnp.asarray(local0), jmesh,
        trigger=jnp.asarray(trig), rotate_k=True, **kw)
    before = tsk.join_kv(tk)
    tk2, _, timp2, tlocal2 = tsk.split_k_prune(
        tk, tk, tsk.shard_tokens(T(x["imp"]), tmesh, -1), T(local0), tmesh,
        trigger=T(trig), rotate_k=True, **kw)
    got = tsk.join_kv(tk2)
    for name in ("full", "msb", "scale"):
        assert torch.equal(getattr(got, name)[1], getattr(before, name)[1])
    np.testing.assert_array_equal(tsk.join_tokens(timp2).numpy(),
                                  np.asarray(jimp2))
    np.testing.assert_array_equal(tlocal2.numpy(), np.asarray(jlocal2))
    # moved rows re-rotate with cos/sin in f32: within one int8 step
    diff = np.abs(got.full.numpy().astype(np.int32)
                  - np.asarray(jk2.full).astype(np.int32))
    assert diff.max() <= 1
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(jk2.scale),
                               rtol=1e-5)


def test_split_k_fused_takes_the_kernel_wrapper(monkeypatch):
    """Every shard's attention goes through K1's wrapper (on CUDA tensors
    that is a kernel launch): one call per shard, each with the split-K
    flags."""
    n = 4
    tmesh = tsk.make_kv_mesh(["cpu"] * n)
    calls = []
    real = tfd.fused_decode_attention

    def spy(*a, **kw):
        calls.append({k: kw[k] for k in ("append_mask", "return_row_stats",
                                         "per_row_importance")})
        return real(*a, **kw)

    monkeypatch.setattr(tsk, "fused_decode_attention", spy)
    x = fused_inputs(3, n, 1, 4, 2, 16, 32)
    tk = tsk.quantize_sharded(T(x["k"]), tmesh)
    tv = tsk.quantize_sharded(T(x["v"]), tmesh, with_msb=False)
    local = T(np.array([[32], [32], [5], [0]], np.int32))
    out = tsk.split_k_decode_fused(
        T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), local, tmesh,
        importance_in=tsk.shard_tokens(T(x["imp"]), tmesh, -1))[0]
    assert torch.isfinite(out).all()
    assert [bool(c["append_mask"][0]) for c in calls] == [False, False, True,
                                                          False]
    assert all(c["return_row_stats"] and c["per_row_importance"]
               for c in calls)
    with pytest.raises(ValueError):
        tsk.make_kv_mesh([])
