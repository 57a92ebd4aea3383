"""K1's plain version sums in the CUDA kernel's order (so that the card
can hold the kernel to it bit for bit), and still matches the JAX Pallas
kernel in interpret mode at the serving flags, on the CPU.

* ``_k1_row_sum`` against a numpy emulation of ``softmax_rows`` in
  ``csrc/fused_decode.cu``: 256 threads each adding columns 8x + 2048k + j
  in order, each warp's xor-shuffle butterfly over lane arrays, then the
  same over the 8 warps' sums: bit-equal;
* ``_ordered_sum``: bit-equal to a sequential f32 loop;
* the plain version at Llama-2-70B's TP-4 shard group (16 query heads over
  2 kv heads, GQA 8) and 3,900 live columns (a thread adds two spans of
  2,048), capacity 4096, under the serving flags (int8 queries, pv_int8,
  probs_bf16, bf16 metadata, V pruning, a requant split), against JAX's
  ``fused_decode_attention(interpret=True)``: out and max prob within
  2e-5 / 1e-4, importance within one bf16 step, need_requant exact --
  ``tests/test_torch_serving.py``'s tolerances.
"""

import jax.numpy as jnp
import numpy as np
import torch

from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)


def softmax_rows_sum(e: np.ndarray, threads: int = 256) -> np.ndarray:
    """f32 [rows] sums of e [rows, C] as the kernel's softmax_rows forms
    them, written with explicit threads and lanes."""
    f = np.float32
    rows, c = e.shape
    out = np.empty(rows, f)
    for r in range(rows):
        part = np.zeros(threads, f)
        for x in range(threads):
            s = f(0)
            for c0 in range(8 * x, c, 8 * threads):
                for j in range(8):
                    if c0 + j < c:
                        s = f(s + e[r, c0 + j])
            part[x] = s

        def warp_sum(v):
            for o in (16, 8, 4, 2, 1):
                v = (v + v[np.arange(32) ^ o]).astype(f)
            return v[0]
        red = np.zeros(32, f)
        red[:threads // 32] = [warp_sum(part[w * 32:(w + 1) * 32])
                               for w in range(threads // 32)]
        out[r] = warp_sum(red)
    return out


def test_row_sum_follows_softmax_rows():
    rng = np.random.default_rng(0)
    e = rng.exponential(size=(3, 4500)).astype(np.float32)
    e[1, 3000:] = 0.0               # columns past a row's length
    e[2, :] = rng.uniform(size=4500).astype(np.float32) ** 8
    got = tfd._k1_row_sum(torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, softmax_rows_sum(e))


def test_ordered_sum_is_sequential():
    rng = np.random.default_rng(1)
    x = rng.exponential(size=(4, 64, 7)).astype(np.float32)
    want = np.zeros((4, 7), np.float32)
    for i in range(64):
        want = (want + x[:, i]).astype(np.float32)
    got = tfd._ordered_sum(torch.from_numpy(x), 1).numpy()
    np.testing.assert_array_equal(got, want)


def f32np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_k1_plain_at_70b_shard_group_matches_pallas():
    b, hq, hkv, d, cap, vb, L, layer = 2, 16, 2, 16, 4096, 64, 2, 1
    rng = np.random.default_rng(7)
    lengths = np.asarray([3900, 2501], np.int32)
    k = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32) * 3.0
    kn = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    vn = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    jk = jqz.quantize(jnp.asarray(k))
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    jk = jk._replace(scale=jk.scale.astype(jnp.bfloat16))
    jv = jv._replace(scale=jv.scale.astype(jnp.bfloat16))
    jimp = jnp.asarray(rng.uniform(size=(L, b, hkv, cap)),
                       jnp.bfloat16)

    def t(x):
        if x is None:
            return None
        if x.dtype == jnp.bfloat16:
            return torch.from_numpy(f32np(x).copy()).bfloat16()
        return torch.from_numpy(np.array(x))
    tk, tv = tqz.QuantizedKV(*(t(x) for x in jk)), tqz.QuantizedKV(
        *(t(x) for x in jv))
    timp = t(jimp)
    kw = dict(sm_scale=d ** -0.5, v_block_size=vb, v_keep=(960, 960),
              quantize_queries=True, pv_int8=True, probs_bf16=True)

    def port(threshold, tk, tv, timp):
        return tfd.fused_decode_attention(
            torch.from_numpy(q), tk, tv, torch.from_numpy(kn),
            torch.from_numpy(vn), torch.from_numpy(lengths),
            requant_threshold=threshold, importance_in=timp, layer=layer,
            **kw)

    def clone(x):
        return tqz.QuantizedKV(*(None if a is None else a.clone()
                                 for a in x))
    mp = np.sort(port(0.0, clone(tk), clone(tv), timp.clone())[1]
                 .max_prob.numpy().ravel())
    threshold = float(mp[1] + mp[2]) / 2          # some heads fire
    tout, tst = port(threshold, tk, tv, timp)[:2]
    jout, jst = jfd.fused_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(lengths), requant_threshold=threshold,
        importance_in=jimp, interpret=True, layer=jnp.int32(layer),
        **kw)[:2]
    assert 0 < int(tst.need_requant.sum()) < b * hkv
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tst.max_prob.numpy(),
                               np.asarray(jst.max_prob), atol=2e-5,
                               rtol=1e-4)
    jimp_out = f32np(jst.importance_delta)
    for bi, n in enumerate(lengths):
        np.testing.assert_allclose(f32np(timp[layer, bi, :, :n]),
                                   jimp_out[layer, bi, :, :n], atol=0,
                                   rtol=2 ** -7)
