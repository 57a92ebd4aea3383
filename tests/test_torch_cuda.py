"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (with a reason) where PyTorch sees no
CUDA device, as on the CPU-only test hosts.  On a machine with one card
and nvcc, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not use.)  K1 runs every GQA group / head_dim instance class it
supports and each serving flag alone (head masks, bf16 metadata, int8
queries, integer P·V, the bf16 probability plane, a capacity rung, 6- and
8-bit layers) and combined; the rules and tolerances are those of
``spatten_tpu_torch/kernel_checks.py``, shared with ``chip_smoke.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from spatten_tpu_torch import kernel_checks as kc
from spatten_tpu_torch.config import (
    EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
)
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer as tr
from spatten_tpu_torch.ops import compact_gather as cg
from spatten_tpu_torch.ops import fused_decode as fd

pytestmark = pytest.mark.cuda


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
    cfg = small_cfg(hkv * group, hkv, d, cap, vb)
    if not quant:
        cfg = dataclasses.replace(cfg, quant=QuantConfig(enabled=False))
    g = torch.Generator(device=dev).manual_seed(group * 1000 + d)
    res = run_pair(dev, cfg, g, [256, 129, 40, 1], requant=quant,
                   v_keep=(40, 40))
    assert res["max_abs_err"] <= 1e-4


def serving_small(*, cap=256, hq=4, hkv=2, d=128, bf16=True,
                  layer_bits=None, quant=True):
    cfg = small_cfg(hq, hkv, d, cap, 16)
    dt = "bfloat16" if bf16 else "float32"
    return dataclasses.replace(
        cfg, quant=QuantConfig(enabled=quant, scale_dtype=dt,
                               layer_bits=layer_bits),
        pruning=dataclasses.replace(cfg.pruning, importance_dtype=dt))


def run_pair(dev, cfg, g, lengths, *, requant, v_keep, layer=1,
             head_mask=None, **flags):
    """K1 vs its plain version on one layer of a random stacked cache."""
    m = cfg.model
    b, vb = len(lengths), cfg.pruning.v_block_size
    st = kc.random_state(cfg, b, g, dev)
    q = torch.randn((b, m.num_heads, 1, m.head_dim), generator=g, device=dev)
    kn = torch.randn((b, m.num_kv_heads, 1, m.head_dim), generator=g,
                     device=dev)
    vn = torch.randn((b, m.num_kv_heads, 1, m.head_dim), generator=g,
                     device=dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = dict(sm_scale=1 / math.sqrt(m.head_dim),
              quant_enabled=cfg.quant.enabled, v_keep=v_keep,
              importance_ema=1.0, **flags)
    if cfg.quant.layer_bits is not None:
        kw["quant_bits"] = st.quant_bits
    threshold = 0.0
    if requant:
        probe = st.clone()
        _, sp, _, _ = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lens, layer=layer,
            v_block_size=vb, importance_in=probe.importance,
            head_mask=head_mask, **kw)
        threshold = kc.split_threshold(sp.max_prob)
    return kc.k1_pair(
        st, q, kn, vn, lens, layer=layer, threshold=threshold, v_block=vb,
        head_mask=head_mask,
        keep_blocks_for=lambda rung: fd._v_keep_blocks(v_keep, vb, rung,
                                                       layer), **kw)


# flag -> (config options, call options)
FLAG_CASES = {
    "head_mask": ({}, dict(head_mask=[True, True, False, False])),
    "head_mask_per_row": ({}, dict(head_mask=[[True, False, True, True],
                                              [False, False, True, False],
                                              [True, True, True, True],
                                              [False, False, False, False]])),
    "bf16_metadata": (dict(bf16=True), {}),
    "quantize_queries": (dict(bf16=False), dict(quantize_queries=True)),
    "pv_int8": (dict(bf16=False), dict(pv_int8=True)),
    "probs_bf16": (dict(bf16=False), dict(probs_bf16=True)),
    "cap_override": (dict(cap=4096, bf16=False), dict(cap_override=2048)),
    "bits6": (dict(layer_bits=(4, 6)), {}),
    "bits8": (dict(layer_bits=(6, 8)), {}),
    "serving": (dict(cap=4096, layer_bits=(4, 6)),
                dict(quantize_queries=True, pv_int8=True, probs_bf16=True,
                     cap_override=2048,
                     head_mask=[False, False, True, False])),
    "dense": (dict(quant=False),
              dict(quantize_queries=True, pv_int8=True, probs_bf16=True)),
}


@pytest.mark.parametrize("case", list(FLAG_CASES))
def test_k1_serving_flags_match_plain(dev, case):
    opts, flags = FLAG_CASES[case]
    cfg = serving_small(**opts)
    g = torch.Generator(device=dev).manual_seed(len(case))
    flags = dict(flags)
    hm = flags.pop("head_mask", None)
    if hm is not None:
        hm = torch.tensor(hm, device=dev)
    lengths = [256, 129, 40, 1] if opts.get("cap", 256) == 256 \
        else [2048, 1501, 900, 33]
    res = run_pair(dev, cfg, g, lengths, requant=opts.get("quant", True),
                   v_keep=(40, 48), head_mask=hm, **flags)
    if hm is not None:
        assert res["dead_groups"] > 0


def test_k1_raises_on_unported_flags(dev):
    cfg = small_cfg(4, 2, 64, 128)
    st = init_state(cfg, 1, device=dev)
    q = torch.zeros((1, 4, 1, 64), device=dev)
    kn = torch.zeros((1, 2, 1, 64), device=dev)
    args = (q, st.cache.k, st.cache.v, kn, kn,
            torch.ones(1, dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError):
        fd.fused_decode_attention(*args, layer=0, importance_in=st.importance,
                                  importance_kind="presoftmax")
    with pytest.raises(NotImplementedError):
        fd.fused_decode_attention(*args, layer=0, importance_in=None)


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
