"""The serving configuration's K1 flags and metadata in the port vs the
JAX package, on the CPU.

K1's plain version against JAX ``fused_decode_attention(interpret=True)``
with the same flags, one flag at a time and combined: int8 queries,
integer P·V, the bf16 probability plane, bf16 scale and importance
planes, head masks, the capacity rung ``cap_override=2048`` at capacity
4096, and 6- and 8-bit pass-1 layers.  Tolerances:

* planes after the append (int8, nibbles, 2-bit fields, f32 or bf16
  scales): exact;
* need_requant: exact (the thresholds sit clear of every max prob);
* out and max prob: atol 2e-5, rtol 1e-4, as tests/test_fused_decode.py
  holds the Pallas kernel to its reference -- the plain version repeats
  the Pallas body's arithmetic, so only f32 summation order differs, and
  an 8-bit P·V weight lands on the same step;
* importance: atol 2e-5, rtol 1e-4 in f32; one bf16 step (rtol 2^-7) in
  bf16, where a last-bit f32 difference may round the other way.

``compact_layer`` and ``append_tokens`` keep bf16 metadata and the 2-bit
plane exactly as JAX does.  ``generate`` on a 3-layer tiny model with the
serving flag set (bf16 metadata, int8 queries, pv_int8, probs_bf16, a
4/6/8 profile, on-the-fly head pruning) is compared with JAX; its greedy
tokens, layer lengths and requant counts agree exactly there.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine import kv_cache as jkv
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz
from spatten_tpu.pruning import compact as jcompact
from spatten_tpu.pruning import token_pruning as jtp

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine import kv_cache as tkv
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz
from spatten_tpu_torch.ops import rope as trope
from spatten_tpu_torch.pruning import compact as tcompact

T = torch.from_numpy
LAYER = 1


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def f32np(x):
    """A JAX or torch array as f32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def to_torch(q, bf16):
    """A JAX QuantizedKV -> the port's, scales in the same dtype."""
    def t(x):
        return None if x is None else torch.from_numpy(f32np(x).copy()) \
            if x.dtype == jnp.bfloat16 else torch.from_numpy(np.array(x))
    out = tqz.QuantizedKV(*(t(x) for x in q))
    return out._replace(scale=out.scale.bfloat16()) if bf16 else out


def k1_inputs(seed, b, hq, hkv, cap, d, lsb2, bf16, L=2):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    x = dict(q=rng.standard_normal((b, hq, 1, d)).astype(np.float32),
             k_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32),
             v_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32))
    jk = jqz.quantize(jnp.asarray(k), with_lsb2=lsb2)
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    jimp = jnp.asarray(rng.uniform(size=(L, b, hkv, cap)), jnp.float32)
    if bf16:
        jk = jk._replace(scale=jk.scale.astype(jnp.bfloat16))
        jv = jv._replace(scale=jv.scale.astype(jnp.bfloat16))
        jimp = jimp.astype(jnp.bfloat16)
    timp = torch.from_numpy(f32np(jimp).copy())
    return x, jk, jv, jimp, to_torch(jk, bf16), to_torch(jv, bf16), \
        timp.bfloat16() if bf16 else timp


# name -> (flags, input shape/metadata options)
CASES = {
    "int8_queries": (dict(quantize_queries=True, requant=True), {}),
    "pv_int8": (dict(pv_int8=True, v_keep=(24, 16)), {}),
    "pv_int8_dense": (dict(pv_int8=True, quant_enabled=False), {}),
    "probs_bf16": (dict(probs_bf16=True, v_keep=(24, 16)), {}),
    "bf16_metadata": (dict(requant=True, v_keep=(24, 16)), dict(bf16=True)),
    "head_mask_dead_group": (dict(head_mask=[True, True, False, False],
                                  v_keep=(24, 16)), {}),
    "head_mask_per_row": (dict(head_mask=[[True, False, False, True],
                                          [False, False, True, False]],
                               requant=True), {}),
    "bits6": (dict(quant_bits=(4, 6), requant=True), dict(lsb2=True)),
    "bits8": (dict(quant_bits=(6, 8), requant=True), dict(lsb2=True)),
    "cap_rung_2048": (dict(cap_override=2048, quantize_queries=True,
                           requant=True, v_keep=(256, 256)),
                      dict(cap=4096, lengths=[901, 1501], vb=16)),
    "serving": (dict(quantize_queries=True, pv_int8=True, probs_bf16=True,
                     quant_bits=(4, 6), requant=True, v_keep=(24, 16),
                     head_mask=[True, True, False, False]),
                dict(bf16=True, lsb2=True)),
    "dense_serving": (dict(quant_enabled=False, quantize_queries=True,
                           pv_int8=True, probs_bf16=True), dict(bf16=True)),
}


def run_k1(flags, opts, seed):
    flags = dict(flags)
    b, hq, hkv, d = 2, 4, 2, 16
    cap, vb = opts.get("cap", 64), opts.get("vb", 8)
    bf16, lsb2 = opts.get("bf16", False), opts.get("lsb2", False)
    lengths = np.asarray(opts.get("lengths", [50, 31]), np.int32)
    x, jk, jv, jimp, tk, tv, timp = k1_inputs(seed, b, hq, hkv, cap, d, lsb2,
                                             bf16)
    hm = flags.pop("head_mask", None)
    qb = flags.pop("quant_bits", None)
    requant = flags.pop("requant", False)
    kw = dict(sm_scale=0.25, v_block_size=vb, **flags)
    tkw = dict(kw, layer=LAYER,
               head_mask=None if hm is None else torch.tensor(hm),
               quant_bits=None if qb is None else torch.tensor(qb))

    def torch_call(threshold, tk, tv, timp):
        return tfd.fused_decode_attention(
            T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), T(lengths),
            requant_threshold=threshold, importance_in=timp, **tkw)

    threshold = 0.0
    if requant:
        # midway across the widest gap between two middle max probs
        probe = [t.clone() if t is not None else None for t in tk]
        mp = torch_call(0.0, tqz.QuantizedKV(*probe), tv.__class__(
            *(t.clone() if t is not None else None for t in tv)),
            timp.clone())[1].max_prob
        mp = np.sort(mp.numpy().ravel())
        mp = mp[mp > 0]
        gaps = mp[1:] - mp[:-1]
        i = int(np.argmax(gaps))
        threshold = float(mp[i] + mp[i + 1]) / 2
        assert gaps[i] > 1e-4
    got = torch_call(threshold, tk, tv, timp)
    want = jfd.fused_decode_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), jnp.asarray(lengths),
        requant_threshold=threshold, importance_in=jimp, interpret=True,
        **dict(kw, layer=jnp.int32(LAYER),
               head_mask=None if hm is None else jnp.asarray(hm),
               quant_bits=None if qb is None else jnp.asarray(qb,
                                                              jnp.int32)))
    return got, want, timp, lengths, hm, bf16


@pytest.mark.parametrize("case", list(CASES))
def test_k1_plain_matches_pallas_flags(case):
    flags, opts = CASES[case]
    (tout, tst, tk, tv), (jout, jst, jk, jv), timp, lengths, hm, bf16 = \
        run_k1(flags, opts, seed=sorted(CASES).index(case))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tst.max_prob.numpy(), np.asarray(jst.max_prob),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    if flags.get("requant"):
        # an 8-bit pass 1 read the int8 plane: it never requantizes
        assert bool(tst.need_requant.any()) == (case != "bits8")
    jimp = f32np(jst.importance_delta)
    imp_tol = dict(atol=0, rtol=2 ** -7) if bf16 else dict(atol=2e-5,
                                                            rtol=1e-4)
    for bi, n in enumerate(lengths):
        np.testing.assert_allclose(f32np(timp[LAYER, bi, :, :n]),
                                   jimp[LAYER, bi, :, :n], **imp_tol)
        for tq, jq in ((tk, jk), (tv, jv)):
            np.testing.assert_array_equal(tq.full[LAYER, bi, :n].numpy(),
                                          np.asarray(jq.full)[LAYER, bi, :n])
            np.testing.assert_array_equal(f32np(tq.scale[LAYER, bi, :, :n]),
                                          f32np(jq.scale[LAYER, bi, :, :n]))
        if flags.get("quant_enabled", True):
            np.testing.assert_array_equal(
                tqz.unpack_msb(tk.msb[LAYER, bi]).numpy()[:n],
                np.asarray(jqz.unpack_msb(jk.msb[LAYER, bi]))[:n])
        if tk.lsb2 is not None:
            np.testing.assert_array_equal(
                tqz.unpack_lsb2(tk.lsb2[LAYER, bi]).numpy()[:n],
                np.asarray(jqz.unpack_lsb2(jk.lsb2[LAYER, bi]))[:n])
    if hm is not None:
        hmb = np.broadcast_to(np.asarray(hm), (2, 4))
        dead = ~hmb.reshape(2, 2, 2).any(-1)                 # [B, Hkv]
        # a dead group: zero output, zero max prob, importance untouched
        out = tout.numpy()[:, :, 0].reshape(2, 2, 2, -1)
        assert (out[dead] == 0).all() and (tst.max_prob.numpy()[dead] == 0
                                           ).all()
        np.testing.assert_array_equal(f32np(timp[LAYER])[dead],
                                      jimp[LAYER][dead])
        assert (tout.numpy()[:, :, 0][~hmb] == 0).all()


def test_k1_rung_equals_full_capacity():
    """cap_override=2048 at capacity 4096 equals the full-capacity call on
    the rung prefix (tests/test_cap_rungs.py:89), in the plain version."""
    flags, opts = CASES["cap_rung_2048"]
    x, _, _, _, tk, tv, timp = k1_inputs(3, 2, 4, 2, 4096, 16, False, False)
    lengths = T(np.array([901, 1501], np.int32))
    outs = []
    for rung in (None, 2048):
        k, v = (tqz.QuantizedKV(*(t.clone() if t is not None else None
                                  for t in q)) for q in (tk, tv))
        imp = timp.clone()
        out, st, k, v = tfd.fused_decode_attention(
            T(x["q"]), k, v, T(x["k_new"]), T(x["v_new"]), lengths,
            sm_scale=0.25, requant_threshold=0.3, quantize_queries=True,
            v_keep=256, v_block_size=16, importance_in=imp, layer=0,
            cap_override=rung)
        outs.append((out, st, k, imp))
    (o1, s1, k1, i1), (o2, s2, k2, i2) = outs
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_array_equal(s1.need_requant.numpy(),
                                  s2.need_requant.numpy())
    assert torch.equal(k1.full[:, :, :2048], k2.full[:, :, :2048])
    assert torch.equal(k1.msb[:, :, :1024], k2.msb[:, :, :1024])
    np.testing.assert_allclose(i1[..., :2048].numpy(), i2[..., :2048].numpy(),
                               atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        tfd.fused_decode_attention(
            T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), lengths,
            importance_in=timp, layer=0, v_block_size=16, cap_override=1000)


@pytest.mark.parametrize("bf16,lsb2", [(True, False), (True, True)])
def test_compact_and_append_keep_metadata(bf16, lsb2):
    """``compact_layer`` (moved-row re-rotation, prefix repack of the
    nibble and 2-bit planes, scale and importance sort) and a multi-row
    ``append_tokens`` with bf16 scales and importance vs JAX."""
    b, h, cap, d = 2, 2, 64, 16
    rng = np.random.default_rng(11)
    kx = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    vx = rng.standard_normal((b, h, cap, d)).astype(np.float32)
    imp = rng.uniform(size=(b, h, cap)).astype(np.float32)
    lengths = np.array([60, 50], np.int32)
    triggered = np.array([True, False])
    keep_idx, keep_count = jtp.select_keep_indices_budgeted(
        jnp.asarray(imp)[None], jnp.asarray(lengths)[None], 2,
        jnp.asarray([8], jnp.int32), 8, 16, 0)
    keep_idx, keep_count = np.array(keep_idx[0]), np.array(keep_count[0])
    keep_idx[1] = np.arange(keep_idx.shape[-1])
    keep_count[1] = keep_idx.shape[-1]
    dt = jnp.bfloat16 if bf16 else jnp.float32
    jk = jqz.quantize(jnp.asarray(kx), with_lsb2=lsb2)
    jk = jk._replace(scale=jk.scale.astype(dt))
    jv = jqz.quantize(jnp.asarray(vx), with_msb=False)
    jv = jv._replace(scale=jv.scale.astype(dt))
    jimp = jnp.asarray(imp).astype(dt)
    tk, tv = to_torch(jk, bf16), to_torch(jv, bf16)
    timp = torch.from_numpy(f32np(jimp).copy()).to(
        torch.bfloat16 if bf16 else torch.float32)
    kw = dict(triggered=triggered, keep_count=keep_count, lengths=lengths)
    jout, jimp2 = jcompact.compact_layer(
        jkv.LayerKVCache(k=jk, v=jv), jimp, jnp.asarray(keep_idx),
        use_gather_kernel=False, rotate_k=True,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    tcache = tkv.LayerKVCache(k=tk, v=tv)
    tcompact.compact_layer(tcache, timp, T(keep_idx), rotate_k=True,
                           rope=trope.rope_lanes(
                               tcfg.ModelConfig(head_dim=d), "cpu"),
                           **{k: T(v) for k, v in kw.items()})
    live = [int(keep_count[0]), cap]
    for bi in range(b):
        n = live[bi]
        for name in ("k", "v"):
            jq, tq = getattr(jout, name), getattr(tcache, name)
            # moved rows are re-rotated with cos/sin: one int8 step
            diff = np.abs(tq.full[bi, :n].numpy().astype(np.int32)
                          - np.asarray(jq.full)[bi, :n].astype(np.int32))
            assert diff.max() <= 1, (name, bi)
            np.testing.assert_allclose(f32np(tq.scale[bi, :, :n]),
                                       f32np(jq.scale[bi, :, :n]),
                                       rtol=2 ** -7 if bf16 else 1e-5)
        np.testing.assert_array_equal(f32np(timp[bi, :, :n]),
                                      f32np(jimp2[bi, :, :n]))
    assert tcache.k.scale.dtype == timp.dtype == (
        torch.bfloat16 if bf16 else torch.float32)
    if lsb2:   # the 2-bit plane is the image of the port's own full plane
        np.testing.assert_array_equal(
            tqz.unpack_lsb2(tcache.k.lsb2).numpy(),
            (tcache.k.full.numpy().astype(np.int32) >> 2) & 3)
    # an 8-row append at ragged offsets, into the compacted cache
    new_k = rng.standard_normal((b, h, 8, d)).astype(np.float32)
    new_v = rng.standard_normal((b, h, 8, d)).astype(np.float32)
    starts = np.array([int(keep_count[0]), 40], np.int32)
    j2 = jkv.append_tokens(jout, jnp.asarray(new_k), jnp.asarray(new_v),
                           jnp.asarray(starts))
    tkv.append_tokens(tcache, T(new_k), T(new_v), T(starts))
    for name in ("k", "v"):
        jq, tq = getattr(j2, name), getattr(tcache, name)
        for bi in range(b):
            rows = slice(int(starts[bi]), int(starts[bi]) + 8)
            np.testing.assert_array_equal(tq.full[bi, rows].numpy(),
                                          np.asarray(jq.full)[bi, rows])
            np.testing.assert_array_equal(f32np(tq.scale[bi, :, rows]),
                                          f32np(jq.scale[bi, :, rows]))
        for pl in ("msb", "lsb2"):
            if getattr(tq, pl) is not None:
                unpack = tqz.unpack_msb if pl == "msb" else tqz.unpack_lsb2
                junpack = jqz.unpack_msb if pl == "msb" else jqz.unpack_lsb2
                for bi in range(b):
                    rows = slice(int(starts[bi]), int(starts[bi]) + 8)
                    np.testing.assert_array_equal(
                        unpack(getattr(tq, pl)[bi]).numpy()[rows],
                        np.asarray(junpack(getattr(jq, pl)[bi]))[rows])


def serving_tiny(mod):
    return mod.SpAttenConfig(
        model=dataclasses.replace(mod.ModelConfig.tiny(), num_layers=3),
        pruning=mod.PruningConfig(
            start_size=2, important_size=8, recent_size=16, v_block_size=8,
            v_keep_ratio=0.25, cascade_layer_ratios=(1.0, 0.78, 0.25),
            enable_head_pruning=True, head_keep=1, head_update_interval=4,
            importance_dtype="bfloat16"),
        quant=mod.QuantConfig(requant_threshold=0.2, quantize_queries=True,
                              pv_int8=True, probs_bf16=True,
                              scale_dtype="bfloat16", layer_bits=(4, 6, 8)),
        engine=mod.EngineConfig(cache_capacity=64, prefill_chunk=8,
                                decode_window=8, max_batch_size=2)).validate()


def test_generate_serving_flags_matches_jax():
    jc, tc = serving_tiny(jcfg), serving_tiny(tcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(2),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(2).integers(
        0, jc.model.vocab_size, (2, 72)).astype(np.int32)
    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), 24)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tres = tgen.generate(tparams, tc, T(prompt), 24, device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.layer_lengths.numpy(),
                                  np.asarray(jres.state.layer_lengths))
    np.testing.assert_array_equal(tres.state.head_mask.numpy(),
                                  np.asarray(jres.state.head_mask))
    assert int(tres.requant_events) == int(jres.requant_events) > 0
    assert tres.state.cache.k.lsb2 is not None
    assert tres.state.importance.dtype == torch.bfloat16
