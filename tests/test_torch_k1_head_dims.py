"""K1 at the head dims and capacities the CUDA kernel runs inside a larger
instance or off the 16-byte grid, in the port vs the JAX package, on the
CPU.

K1's plain version against JAX ``fused_decode_attention(interpret=True)``
on the same numpy inputs under the serving flags (int8 queries, the bf16
probability plane, bf16 scales and importance, requant, V pruning, a
partly head-masked group; integer P·V where the Pallas kernel applies it,
``fused_decode.py:2050``):

* head dims: OpenLLaMA-3B's attention (32 query heads over 32 kv heads of
  100), 16 over 8 of 80 with a 6-bit layer, and 12 over 4 of 96 (GQA 3),
  at capacity 64 (32 kv heads in interpret mode are slow);
* capacities off a multiple of 8: 1020 tokens at v_block 4 (pack unit
  1020, half-unit 510), with bf16 and with f32 scale planes, and at
  v_block 6; and 3000 tokens called at the rung 1500 (pack unit 1500,
  half-unit 750) with a 6-bit layer.  The Pallas kernel sums V-block
  masses over tiles of one half-unit (``fused_decode.py:1478-1492``), so
  at a v_block that does not divide it (4 into 510) its blocks straddle
  tiles and its keep sets are not the kernel's rule; there the output is
  compared with V pruning off, while the keep sets (derived from the two
  packages' probability deltas, which V pruning does not touch) are held
  with it on.  v_block 6 divides 510 and runs V pruning in both.  The
  Pallas kernel also writes an appended row whose slot lies in the last
  partial 8-row group of its plane (int8 slots 1016-1019 of 1020; packed
  rows 504-509 of a 510-row half-unit, lsb2 rows 368-374 of a 375-row
  quarter-unit) to another slot, and at the rung 1500 it rewrites the
  128-column scale tile that holds the appended column with other values
  where that tile crosses the rung ([1408, 1536)); so the lengths here
  append below those; the card's ``phase_k1_capacity`` holds K1 against
  its plain version at full length.

Tolerances, as ``tests/test_torch_k1_groups.py``: planes after the append
(int8, nibbles, 2-bit fields, bf16 scales) exact, f32 scales within one
ulp (XLA computes the appended row's ``amax / 127`` as a multiply by the
reciprocal); need_requant exact (the
threshold sits clear of every max prob); out and max prob atol 2e-5,
rtol 1e-4 (f32 summation order); importance one bf16 step (rtol 2^-7;
f32 planes 2e-5 / 1e-4); the per-row probability deltas of a second call
in delta mode within 2e-5 / 1e-4 and the kept V blocks derived from them
by the kernel's counting rule exact.

Then ``fused_decode.k1_shape_error`` and ``instance_dim`` at their new
boundaries: every head_dim up to 256 in the smallest instance dim that
holds it, every even capacity and rung, and nothing past 256 lanes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)

T = torch.from_numpy
LAYER = 1
TOL = dict(atol=2e-5, rtol=1e-4)


# name -> (query heads, kv heads, head_dim, stored capacity, rung,
#          v_block, V keep per layer, lengths, 6-bit layer, bf16 metadata)
SHAPES = {
    "OpenLLaMA-3B 32/32 x 100": (32, 32, 100, 64, 64, 8, (24, 16),
                                 (50, 31), False, True),
    "16/8 x 80 6-bit": (16, 8, 80, 64, 64, 8, (24, 16), (50, 31), True,
                        True),
    "G3 12/4 x 96": (12, 4, 96, 64, 64, 8, (24, 16), (50, 31), False, True),
    "capacity 1020 v_block 4 bf16": (4, 2, 64, 1020, 1020, 4, (400, 300),
                                     (1013, 701), False, True),
    "capacity 1020 v_block 4 f32": (4, 2, 64, 1020, 1020, 4, (400, 300),
                                    (1009, 513), False, False),
    "capacity 1020 v_block 6": (4, 2, 64, 1020, 1020, 6, (400, 300),
                                (1013, 701), False, True),
    "capacity 3000 rung 1500 6-bit": (8, 1, 128, 3000, 1500, 50,
                                      (600, 480), (1400, 997), True, True),
}


def pallas_block_masses_straddle(name) -> bool:
    """Whether the Pallas kernel's half-unit mass tiles split V blocks."""
    _, _, _, _, rung, vb, *_ = SHAPES[name]
    return (tqz.pack_unit(rung) // 2) % vb != 0


def jax_applies_pv_int8(hq: int) -> bool:
    """Whether the Pallas kernel in interpret mode (one program over every
    kv head: ``hq`` rows) runs integer P·V (``fused_decode.py:2050``)."""
    return hq % 8 == 0 or 8 % hq == 0


def f32np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def head_mask(hq: int, hkv: int) -> np.ndarray:
    """Every group alive but the last, whose first row is dead."""
    hm = np.ones((hkv, hq // hkv), bool)
    hm[-1, 0] = False
    return hm.reshape(hq)


def inputs(name):
    hq, hkv, d, cap, _, _, _, lengths, six, bf16 = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name) + 11)
    b, L = len(lengths), 2
    k = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    x = {n: rng.standard_normal(sh).astype(np.float32) for n, sh in
         (("q", (b, hq, 1, d)), ("k_new", (b, hkv, 1, d)),
          ("v_new", (b, hkv, 1, d)))}
    meta = jnp.bfloat16 if bf16 else jnp.float32
    jk = jqz.quantize(jnp.asarray(k), with_lsb2=six)
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    jk = jk._replace(scale=jk.scale.astype(meta))
    jv = jv._replace(scale=jv.scale.astype(meta))
    jimp = jnp.asarray(rng.uniform(size=(L, b, hkv, cap)), meta)
    return x, jk, jv, jimp


def to_torch(a):
    """A JAX array -> a tensor (bf16 kept bf16)."""
    if a is None:
        return None
    if a.dtype == jnp.bfloat16:
        return T(f32np(a).copy()).bfloat16()
    return T(np.array(a))


def flags(name, threshold, v_keep=None):
    hq, _, _, cap, rung, vb, vk, _, six, _ = SHAPES[name]
    v_keep = vk if v_keep is None else v_keep
    return dict(sm_scale=0.25, v_block_size=vb, v_keep=v_keep,
                requant_threshold=threshold, quantize_queries=True,
                probs_bf16=True, pv_int8=jax_applies_pv_int8(hq),
                cap_override=rung if rung < cap else None,
                quant_bits=(4, 6) if six else None)


def run_port(name, x, jk, jv, jimp, threshold, delta_mode=False,
             v_keep=None):
    hq, hkv, *_, lengths, _, _ = SHAPES[name]
    kw = flags(name, threshold, v_keep)
    qb = kw.pop("quant_bits")
    imp = None if delta_mode else to_torch(jimp)
    tk = tqz.QuantizedKV(*(to_torch(a) for a in jk))
    tv = tqz.QuantizedKV(*(to_torch(a) for a in jv))
    out, st, tk, tv = tfd.fused_decode_attention(
        T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]),
        T(np.asarray(lengths, np.int32)), layer=LAYER,
        head_mask=T(head_mask(hq, hkv)),
        quant_bits=None if qb is None else torch.tensor(qb),
        importance_in=imp, per_row_importance=delta_mode, **kw)
    return out, st, tk, tv, imp


def run_jax(name, x, jk, jv, jimp, threshold, delta_mode=False,
            v_keep=None):
    hq, hkv, *_, lengths, _, _ = SHAPES[name]
    kw = flags(name, threshold, v_keep)
    qb = kw.pop("quant_bits")
    return jfd.fused_decode_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), jnp.asarray(np.asarray(lengths, np.int32)),
        layer=jnp.int32(LAYER), head_mask=jnp.asarray(head_mask(hq, hkv)),
        quant_bits=None if qb is None else jnp.asarray(qb, jnp.int32),
        importance_in=None if delta_mode else jimp,
        per_row_importance=delta_mode, interpret=True, **kw)


def split_threshold(max_prob: np.ndarray) -> float:
    """Midway across the widest gap between two live max probs."""
    mp = np.sort(max_prob.ravel())
    mp = mp[mp > 0]
    gaps = mp[1:] - mp[:-1]
    i = int(np.argmax(gaps))
    assert gaps[i] > 1e-4
    return float(mp[i] + mp[i + 1]) / 2


def keep_sets(delta: np.ndarray, kb: int, vb: int):
    """Each row's kept V blocks by the kernel's counting rule (the blocks
    whose mass reaches the kb-th largest, mass > 0) from per-row
    probability deltas [B, Hq, C]; and the smallest gap between a row's
    kb-th and (kb+1)-th block mass among rows that keep any."""
    mass = delta.reshape(delta.shape[:2] + (-1, vb)).sum(-1)
    srt = -np.sort(-mass, axis=-1)
    kth, nxt = srt[..., kb - 1:kb], srt[..., kb:kb + 1]
    keep = (mass >= kth) & (mass > 0)
    live = kth[..., 0] > 0
    return keep, float((kth - nxt)[..., 0][live].min())


@pytest.mark.parametrize("name", list(SHAPES))
def test_k1_plain_matches_pallas_at_shape(name):
    hq, hkv, d, cap, rung, vb, v_keep, lengths, six, bf16 = SHAPES[name]
    assert tfd.k1_shape_error(hq // hkv, d, cap, rung, vb) is None
    x, jk, jv, jimp = inputs(name)
    threshold = split_threshold(
        run_port(name, x, jk, jv, jimp, 0.0)[1].max_prob.numpy())
    # V pruning off where the Pallas kernel's mass tiles split V blocks
    vk = (0, 0) if pallas_block_masses_straddle(name) else None
    tout, tst, tk, tv, timp = run_port(name, x, jk, jv, jimp, threshold,
                                       v_keep=vk)
    jout, jst, jk2, jv2 = run_jax(name, x, jk, jv, jimp, threshold,
                                  v_keep=vk)
    assert tout.shape == (len(lengths), hq, 1, d)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst.max_prob.numpy(),
                               np.asarray(jst.max_prob), **TOL)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    assert tst.need_requant.any() and not tst.need_requant.all()
    jimp2 = f32np(jst.importance_delta)
    imp_tol = dict(atol=0, rtol=2 ** -7) if bf16 else TOL
    hm = head_mask(hq, hkv)
    for bi, n in enumerate(lengths):
        np.testing.assert_allclose(f32np(timp[LAYER, bi, :, :n]),
                                   jimp2[LAYER, bi, :, :n], **imp_tol)
        for tq, jq in ((tk, jk2), (tv, jv2)):
            np.testing.assert_array_equal(tq.full[LAYER, bi, :n].numpy(),
                                          np.asarray(jq.full)[LAYER, bi, :n])
            np.testing.assert_array_max_ulp(
                f32np(tq.scale[LAYER, bi, :, :n]),
                f32np(jq.scale[LAYER, bi, :, :n]), maxulp=0 if bf16 else 1)
        np.testing.assert_array_equal(
            tqz.unpack_msb(tk.msb[LAYER, bi]).numpy()[:n],
            np.asarray(jqz.unpack_msb(jk2.msb[LAYER, bi]))[:n])
        if six:
            np.testing.assert_array_equal(
                tqz.unpack_lsb2(tk.lsb2[LAYER, bi]).numpy()[:n],
                np.asarray(jqz.unpack_lsb2(jk2.lsb2[LAYER, bi]))[:n])
    # the partly alive group's dead row reads zero in both
    assert (tout.numpy()[:, ~hm] == 0).all()

    # keep sets, from a second call in per-row delta mode
    tdel = run_port(name, x, jk, jv, jimp, threshold, delta_mode=True)[1]
    jdel = run_jax(name, x, jk, jv, jimp, threshold, delta_mode=True)[1]
    tdel = tdel.importance_delta.numpy()
    jdel = np.asarray(jdel.importance_delta)
    assert tdel.shape[-1] == rung and tdel.shape == jdel.shape
    if tdel.shape[1] == hkv:              # MHA: per-row is per-head
        assert hq == hkv
    np.testing.assert_allclose(tdel, jdel, **TOL)
    kb = tfd._v_keep_blocks(v_keep, vb, rung, LAYER)
    assert 0 < kb < rung // vb
    tkeep, tgap = keep_sets(tdel, kb, vb)
    jkeep, jgap = keep_sets(jdel, kb, vb)
    assert min(tgap, jgap) > 1e-6        # no tie for the last kept block
    np.testing.assert_array_equal(tkeep, jkeep)


@pytest.mark.parametrize("head_dim,dim", [
    (8, 128), (40, 128), (48, 128), (64, 64), (80, 128), (96, 128),
    (100, 128), (120, 128), (124, 256), (128, 128), (160, 256),
    (256, 256)])
def test_instance_dim_is_the_smallest_that_holds_the_head(head_dim, dim):
    """The smallest instance dim that holds head_dim lanes after a box
    row's lead-in (up to 16 - gcd(head_dim, 16) bytes: 124 needs 256); no
    head_dim but 64 runs in 64 (rows below the dim are read only in
    boxes, and a V piece of an odd number of 64-byte rows would not land
    128-byte aligned)."""
    assert tfd.instance_dim(head_dim) == dim
    for v_block in (1, 3, 16, 64):
        assert tfd.k1_shape_error(1, head_dim, 1024, 1024, v_block) is None


def test_k1_shape_error_boundaries():
    """Refused: a head_dim below 1.  Past 256 lanes (250 with its
    lead-in) the head runs in <G, 256> as lane pieces.  Taken: groups past
    8 (in chunks of 8 rows), windows whose plan passes 227 KB even with
    the score plane in device memory (their V-block arrays move there
    too), OpenLLaMA-3B's head_dim 100 at its serving rungs, 80 and 96,
    capacities 1020 (v_block 4) and 3000 at the rung 1500."""
    for d in (250, 257, 320):
        assert tfd.k1_shape_error(1, d, 64, 64, 8) is None
        assert tfd.instance_dim(d) == 256 and tfd.lane_pieces(d) == 2
    assert tfd.lane_pieces(256) == tfd.lane_pieces(248) == 1
    assert "head_dim 0" in tfd.k1_shape_error(1, 0, 64, 64, 8)
    with pytest.raises(ValueError):
        tfd.instance_dim(0)
    assert tfd.k1_shape_error(9, 100, 64, 64, 8) is None
    assert tfd.k1_shape_error(8, 100, 262144, 262144, 64) is None
    assert not tfd.k1_plan(8, 100, 262144, 64).blocks_in_smem
    for d, group in ((100, 1), (80, 2), (96, 3)):
        for rung in (1024, 2048):
            assert tfd.k1_shape_error(group, d, 2048, rung, 64) is None
    assert tfd.k1_shape_error(1, 128, 1020, 1020, 4) is None
    assert tfd.k1_shape_error(1, 128, 3000, 1500, 60) is None
    # the plan is the instance dim's
    assert tfd.smem_bytes(1, tfd.instance_dim(100), 2048, 64) == \
        tfd.smem_bytes(1, 128, 2048, 64)
    with pytest.raises(ValueError):
        tfd.smem_bytes(1, 100, 2048, 64)
