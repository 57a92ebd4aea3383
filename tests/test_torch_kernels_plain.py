"""The plain PyTorch versions of the two CUDA kernels vs the JAX Pallas
kernels they replace, run in interpret mode on the CPU.

K1 ``fused_decode_attention`` in stacked mode (a ``layer`` index into
[L, ...] planes, importance accumulated in place): out and max_prob within
atol 2e-5 / rtol 1e-4 (the tolerances of tests/test_fused_decode.py),
need_requant and the appended planes exact.  K2 ``gather_compact_rows``:
every live row byte-exact, untriggered sequences untouched.  Also the
wrappers' dispatch rule and the entry points' refusal to run on a host
without CUDA unless asked for the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu.ops import compact_gather as jcg
from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models.transformer import init_params
from spatten_tpu_torch.ops import compact_gather as tcg
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def stacked_inputs(seed, L=2, b=2, hq=4, hkv=2, cap=64, d=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    k = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, cap, d)).astype(np.float32)
    k_new = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    v_new = rng.standard_normal((b, hkv, 1, d)).astype(np.float32)
    imp = rng.uniform(size=(L, b, hkv, cap)).astype(np.float32)
    return q, k, v, k_new, v_new, imp


def run_k1(seed, lengths, quant_enabled, v_keep, ema, hq=4, hkv=2,
           pick_threshold=True):
    q, k, v, k_new, v_new, imp = stacked_inputs(seed, hq=hq, hkv=hkv)
    layer = 1
    lengths = np.asarray(lengths, np.int32)
    kw = dict(sm_scale=0.25, quant_enabled=quant_enabled, v_keep=v_keep,
              v_block_size=8, importance_ema=ema, layer=layer)

    def torch_call(threshold):
        kq, vq = tqz.quantize(T(k)), tqz.quantize(T(v), with_msb=False)
        timp = T(imp.copy())
        out, st, kq, vq = tfd.fused_decode_attention(
            T(q), kq, vq, T(k_new), T(v_new), T(lengths),
            requant_threshold=threshold, importance_in=timp, **kw)
        return out, st, kq, vq, timp

    threshold = 0.0
    if quant_enabled and pick_threshold:
        # midway between two pass-1 max probs: some heads fire, some not
        mp = np.sort(torch_call(0.0)[1].max_prob.numpy().ravel())
        i = len(mp) // 2
        threshold = float(mp[i - 1] + mp[i]) / 2
        assert mp[i] - mp[i - 1] > 2e-4
    tout, tst, tk, tv, timp = torch_call(threshold)
    jout, jst, jk, jv = jfd.fused_decode_attention(
        jnp.asarray(q), jqz.quantize(jnp.asarray(k)),
        jqz.quantize(jnp.asarray(v), with_msb=False), jnp.asarray(k_new),
        jnp.asarray(v_new), jnp.asarray(lengths),
        requant_threshold=threshold, importance_in=jnp.asarray(imp),
        interpret=True, **dict(kw, layer=jnp.int32(layer)))
    return (tout, tst, tk, tv, timp), (jout, jst, jk, jv), lengths, layer


@pytest.mark.parametrize("case", ["quant_requant_gqa_vprune",
                                  "dense_mha_ema"])
def test_k1_plain_matches_pallas(case):
    if case == "quant_requant_gqa_vprune":
        got, want, lengths, layer = run_k1(
            0, [50, 31], quant_enabled=True, v_keep=(24, 16), ema=1.0)
    else:
        got, want, lengths, layer = run_k1(
            1, [64, 9], quant_enabled=False, v_keep=0, ema=0.9, hq=2, hkv=2)
    tout, tst, tk, tv, timp = got
    jout, jst, jk, jv = want
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(tst.max_prob.numpy(), np.asarray(jst.max_prob),
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    if case == "quant_requant_gqa_vprune":
        assert tst.need_requant.any() and not tst.need_requant.all()
    jimp = np.asarray(jst.importance_delta)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(timp[layer, b, :, :n].numpy(),
                                   jimp[layer, b, :, :n], atol=2e-5,
                                   rtol=1e-4)
        for name in ("full", "scale"):
            for tq, jq in ((tk, jk), (tv, jv)):
                np.testing.assert_array_equal(
                    getattr(tq, name)[layer, b, ..., :n, :].numpy()
                    if name == "full" else
                    getattr(tq, name)[layer, b, :, :n].numpy(),
                    np.asarray(getattr(jq, name))[layer, b, ..., :n, :]
                    if name == "full" else
                    np.asarray(getattr(jq, name))[layer, b, :, :n])
        if case == "quant_requant_gqa_vprune":
            np.testing.assert_array_equal(
                tqz.unpack_msb(tk.msb[layer, b]).numpy()[:n],
                np.asarray(jqz.unpack_msb(jk.msb[layer, b]))[:n])
    # the other layer is untouched
    np.testing.assert_array_equal(tk.full[0].numpy(),
                                  np.asarray(jk.full)[0])
    np.testing.assert_array_equal(timp[0].numpy(), jimp[0])


def test_k2_plain_matches_pallas():
    b, cap, h, d = 3, 64, 2, 16
    rng = np.random.default_rng(5)
    kp = rng.integers(-127, 128, (b, cap, h * d)).astype(np.int8)
    vp = rng.integers(-127, 128, (b, cap, h * d)).astype(np.int8)
    lengths = np.array([60, 64, 41], np.int32)
    triggered = np.array([1, 0, 1], np.int32)
    keep_max = 30
    keep_idx = np.zeros((b, h, keep_max), np.int32)
    keep_count = np.array([30, 30, 22], np.int32)
    for bi in range(b):
        for hi in range(h):
            n = keep_count[bi]
            keep_idx[bi, hi, :n] = np.sort(
                rng.permutation(lengths[bi])[:n])
    jk, jv = jcg.gather_compact_rows(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(keep_idx),
        jnp.asarray(lengths), jnp.asarray(triggered),
        keep_count=jnp.asarray(keep_count), interpret=True)
    tk, tv = T(kp.copy()), T(vp.copy())
    before = tcg.gather_compact_rows.launches
    out = tcg.gather_compact_rows(tk, tv, T(keep_idx), T(lengths),
                                  T(triggered), keep_count=T(keep_count))
    assert out[0] is tk and tcg.gather_compact_rows.launches == before
    for bi in range(b):
        n = keep_count[bi] if triggered[bi] else cap
        for t_pl, j_pl, orig in ((tk, jk, kp), (tv, jv, vp)):
            np.testing.assert_array_equal(t_pl[bi, :n].numpy(),
                                          np.asarray(j_pl)[bi, :n])
            if triggered[bi]:
                # rows past the keep count: the plain version leaves them
                np.testing.assert_array_equal(t_pl[bi, n:].numpy(),
                                              orig[bi, n:])
            else:
                np.testing.assert_array_equal(t_pl[bi].numpy(), orig[bi])


def test_k1_wrapper_runs_plain_on_cpu_only():
    q, k, v, k_new, v_new, imp = stacked_inputs(3)
    before = tfd.fused_decode_attention.launches
    kq, vq = tqz.quantize(T(k)), tqz.quantize(T(v), with_msb=False)
    args = (T(q), kq, vq, T(k_new), T(v_new),
            torch.tensor([40, 12], dtype=torch.int32))
    tfd.fused_decode_attention(*args, layer=0, importance_in=T(imp))
    assert tfd.fused_decode_attention.launches == before
    with pytest.raises(ValueError):
        tfd.fused_decode_attention(*args, layer=0, importance_in=T(imp),
                                   keep_out=torch.zeros(1, dtype=torch.uint8))


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """Without CUDA, the default device raises; device='cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfg.SpAttenConfig(model=tcfg.ModelConfig.tiny(),
                             engine=tcfg.EngineConfig(cache_capacity=1024))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_state(cfg, batch=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg.model, 0)
    assert init_state(cfg, batch=1, device="cpu").capacity == 1024
