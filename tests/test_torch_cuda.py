"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (with a reason) where PyTorch sees no
CUDA device, as on the CPU-only test hosts.  On a machine with one card
and nvcc, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not use.)  K1 runs every GQA group / head_dim instance class it
supports; decisions within 1e-5 of their threshold may resolve either way
and are excluded, as in ``chip_smoke.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from spatten_tpu_torch.config import (
    EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
)
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer as tr
from spatten_tpu_torch.ops import compact_gather as cg
from spatten_tpu_torch.ops import fused_decode as fd
from spatten_tpu_torch.ops import quantize as qz

pytestmark = pytest.mark.cuda
MARGIN = 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def small_cfg(hq, hkv, d, cap, vb=16):
    return SpAttenConfig(
        model=ModelConfig(vocab_size=64, hidden_size=hq * d, num_layers=2,
                          num_heads=hq, num_kv_heads=hkv, head_dim=d,
                          intermediate_size=64),
        pruning=PruningConfig(start_size=4, important_size=16,
                              recent_size=32, v_block_size=vb),
        engine=EngineConfig(cache_capacity=cap, prefill_chunk=8))


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("group,d", [(1, 128), (2, 64), (4, 128), (8, 64)])
def test_k1_matches_plain(dev, group, d, quant):
    hkv, cap, vb = 2, 256, 16
    lengths = [256, 129, 40, 1]
    cfg = small_cfg(hkv * group, hkv, d, cap, vb)
    g = torch.Generator(device=dev).manual_seed(group * 1000 + d)
    b, hq = len(lengths), hkv * group
    st = init_state(cfg, b, device=dev)
    k = qz.quantize(torch.randn((b, hkv, cap, d), generator=g, device=dev))
    v = qz.quantize(torch.randn((b, hkv, cap, d), generator=g, device=dev),
                    with_msb=False)
    for dst, src in ((st.cache.k, k), (st.cache.v, v)):
        for name in ("full", "msb", "scale"):
            if getattr(dst, name) is not None:
                getattr(dst, name).copy_(getattr(src, name)[None])
    st.importance.uniform_(generator=g)
    q = torch.randn((b, hq, 1, d), generator=g, device=dev)
    kn = torch.randn((b, hkv, 1, d), generator=g, device=dev)
    vn = torch.randn((b, hkv, 1, d), generator=g, device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(sm_scale=1 / math.sqrt(d), quant_enabled=quant,
              requant_threshold=0.05 if quant else 0.0, v_keep=(40, 40),
              v_block_size=vb, layer=1)
    a, c = st.clone(), st.clone()
    nvb = cap // vb
    keep = torch.zeros((b, hq, nvb), dtype=torch.uint8, device=dev)
    before = fd.fused_decode_attention.launches
    out_k, sk, _, _ = fd.fused_decode_attention(
        q, a.cache.k, a.cache.v, kn, vn, lens, importance_in=a.importance,
        keep_out=keep, **kw)
    out_p, sp, _, _ = fd.fused_decode_attention_plain(
        q, c.cache.k, c.cache.v, kn, vn, lens, importance_in=c.importance,
        **kw)
    torch.cuda.synchronize()
    assert fd.fused_decode_attention.launches == before + 1
    for x, y in ((a.cache.k, c.cache.k), (a.cache.v, c.cache.v)):
        assert torch.equal(x.full, y.full) and torch.equal(x.scale, y.scale)
    if quant:
        assert torch.equal(a.cache.k.msb, c.cache.k.msb)
    near_t = (sp.max_prob - kw["requant_threshold"]).abs() < MARGIN
    assert not ((sk.need_requant != sp.need_requant) & ~near_t).any()
    mass = sp.probs[:, :, 0].reshape(b, hq, nvb, vb).sum(-1)
    kb = -(-40 // vb)
    srt = torch.sort(mass, dim=-1, descending=True).values
    kth, nxt = srt[..., kb - 1:kb], srt[..., kb:kb + 1]
    row_near = (((kth - nxt)[..., 0] < MARGIN) & (kth[..., 0] > 0)) \
        | near_t.repeat_interleave(group, dim=1)
    keep_p = (mass >= kth) & (mass > 0)
    margin = torch.where(keep_p, mass - nxt, kth - mass)
    assert not ((keep.bool() != keep_p) & (margin >= MARGIN)
                & ~row_near[..., None]).any()
    torch.testing.assert_close(out_k[~row_near], out_p[~row_near],
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(sk.max_prob, sp.max_prob, atol=1e-6,
                               rtol=1e-4)
    for bi, n in enumerate(lengths):
        alive = ~near_t[bi]
        torch.testing.assert_close(a.importance[1, bi, alive, :n],
                                   c.importance[1, bi, alive, :n],
                                   atol=1e-5, rtol=1e-4)
    assert torch.equal(a.importance[0], c.importance[0])


def test_k1_raises_on_unported_flags(dev):
    cfg = small_cfg(4, 2, 64, 128)
    st = init_state(cfg, 1, device=dev)
    q = torch.zeros((1, 4, 1, 64), device=dev)
    kn = torch.zeros((1, 2, 1, 64), device=dev)
    with pytest.raises(NotImplementedError):
        fd.fused_decode_attention(
            q, st.cache.k, st.cache.v, kn, kn,
            torch.ones(1, dtype=torch.int32, device=dev), layer=0,
            importance_in=st.importance,
            head_mask=torch.ones(4, dtype=torch.bool, device=dev))


def test_k2_matches_plain(dev):
    b, cap, h, d, keep_max = 3, 512, 4, 64, 200
    rng = np.random.default_rng(7)
    idx = np.zeros((b, h, keep_max), np.int32)
    keep_count = np.array([200, 200, 150], np.int32)
    lengths = np.array([512, 300, 480], np.int32)
    for bi in range(b):
        for hi in range(h):
            n = keep_count[bi]
            idx[bi, hi, :n] = np.sort(rng.permutation(lengths[bi])[:n])
    gen_ = torch.Generator(device=dev).manual_seed(3)
    k0 = torch.randint(-127, 128, (b, cap, h * d), generator=gen_,
                       device=dev, dtype=torch.int8)
    v0 = torch.randint(-127, 128, (b, cap, h * d), generator=gen_,
                       device=dev, dtype=torch.int8)
    args = [torch.from_numpy(x).to(dev) for x in
            (idx, lengths, np.array([1, 0, 1], np.int32))]
    kc = torch.from_numpy(keep_count).to(dev)
    kk, vk, kp, vp = k0.clone(), v0.clone(), k0.clone(), v0.clone()
    cg.gather_compact_rows(kk, vk, *args, keep_count=kc)
    cg.gather_compact_rows_plain(kp, vp, *args, keep_count=kc)
    assert torch.equal(kk, kp) and torch.equal(vk, vp)
    assert torch.equal(kk[1], k0[1])


def test_engine_kernels_match_plain_path(dev):
    """A small f32 GQA model through prefill (with prunes) and a decode
    window that starts with a prune: kernel path vs plain path, the same
    tokens fed to both."""
    cfg = SpAttenConfig(
        model=ModelConfig(vocab_size=256, hidden_size=256, num_layers=2,
                          num_heads=4, num_kv_heads=2, head_dim=64,
                          intermediate_size=256),
        pruning=PruningConfig(start_size=4, important_size=16,
                              recent_size=32, v_block_size=16),
        quant=QuantConfig(requant_threshold=0.1),
        engine=EngineConfig(max_batch_size=2, cache_capacity=128,
                            prefill_chunk=32, decode_window=16),
    ).validate()
    cfgs = [cfg, dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, use_pallas=False))]
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device=dev)
    prompt = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 200))).to(dev)
    out = [gen.prefill(params, c, init_state(c, 2, device=dev), prompt)
           for c in cfgs]
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-5, rtol=0)
    states = [o[1] for o in out]
    tok = torch.argmax(out[1][0], -1).to(torch.int32)
    layers, _ = gen.prune_schedule_step(cfg, out[1][2], 16)
    assert layers                      # the window starts with a prune
    for i, c in enumerate(cfgs):
        states[i], _ = gen.maybe_prune(c, states[i], 16, static_layers=layers)
    errs = []
    for _ in range(16):
        logits = []
        for i, c in enumerate(cfgs):
            lg, states[i], _ = tr.forward(params, c, states[i], tok[:, None])
            logits.append(lg[:, -1])
        errs.append(float((logits[0] - logits[1]).abs().max()))
        tok = torch.argmax(logits[1], -1).to(torch.int32)
    assert np.mean(np.asarray(errs) <= 1e-3) >= 0.9, errs
