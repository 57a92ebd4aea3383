"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: every test skips (with a reason) where PyTorch sees no
CUDA device, as on the CPU-only test hosts.  On a machine with one card
and nvcc, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX, which this file
does not use.)  K1 runs every GQA group / head_dim instance class it
supports, the groups 3, 5, 6 and 7 that it runs in a larger instance
(with the score plane in shared and in device memory, a partly alive
group among them), and each serving flag alone (head masks, bf16
metadata, int8 queries, integer P·V, the bf16 probability plane, a
capacity rung, 6- and 8-bit layers) and combined, presoftmax and
delta-mode importance, the split-K flags (rows that do not append, an
empty shard, row stats, per-row importance under GQA) and
``_skip_append`` (no plane byte written, the appending step's
outputs); a small
split-K step runs K1 per shard against one unsharded K1 call, at GQA
groups 2 and 3; P1-P5 of the launch probe equal their plain versions (P2
over the whole block, P3 on random bytes and on planes of -128 and 127,
P4 at its int8 wrap edges, P5 at negative and large scalars) and refuse
misaligned views.  K1 with its score plane in device memory (GQA 8 at
4096 tokens, GQA 4 at 16384) matches its plain version, and so does K1
at head dims off its instances (100, 80, 96) and at stored capacities
and rungs off a multiple of 8 (1020; 3000 at the rung 1500), and at head
dims past 256 lanes (384, 512, 1024), which it runs in <G, 256> as lane
pieces.  A ShardedEngine on one NCCL rank gives ``generate``'s tokens.
``generate``
runs on the card for a configuration that the gate sends off K1
(``chip_smoke.gate_configs()``), for one whose K1 score plane lies in
device memory (``chip_smoke.device_scores_configs()``) and for a GQA-3
model (``chip_smoke.group_configs()``), each call held against its CPU
replay, and so does a two-request ``SpAttenServer`` run on the GQA-3
model.  The rules and tolerances are those of
``spatten_tpu_torch/kernel_checks.py``, shared with ``chip_smoke.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import chip_smoke
from spatten_tpu_torch import kernel_checks as kc
from spatten_tpu_torch.config import (
    EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
)
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer as tr
from spatten_tpu_torch.ops import compact_gather as cg
from spatten_tpu_torch.ops import fused_decode as fd
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.parallel import split_k as sk
from spatten_tpu_torch.tools import launch_overhead as lo

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
@pytest.mark.parametrize("group,d", [(1, 128), (2, 64), (4, 128), (8, 64),
                                     (3, 64), (5, 128), (6, 64), (7, 128)])
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
             head_mask=None, delta_mode=False, threshold=None, **flags):
    """K1 vs its plain version on one layer of a random stacked cache
    (``threshold``: a fixed requant threshold instead of a split one)."""
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
    if threshold is None and not requant:
        threshold = 0.0
    elif threshold is None:
        probe = st.clone()
        sp = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lens, layer=layer,
            v_block_size=vb, importance_in=probe.importance,
            head_mask=head_mask, **kw)[1]
        threshold = kc.split_threshold(sp.max_prob)
    return kc.k1_pair(
        st, q, kn, vn, lens, layer=layer, threshold=threshold, v_block=vb,
        head_mask=head_mask, delta_mode=delta_mode,
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


@pytest.mark.parametrize("case", ["serving", "bits6", "head_mask", "dense"])
def test_k1_skip_append_matches_plain(dev, case):
    """K1's _skip_append against its plain version: every plane and scale
    equal after the call (the plain version puts the int8, nibble and
    2-bit planes back, so neither writes them) and the outputs of the
    appending step."""
    opts, flags = FLAG_CASES[case]
    cfg = serving_small(**opts)
    g = torch.Generator(device=dev).manual_seed(100 + len(case))
    flags = dict(flags)
    hm = flags.pop("head_mask", None)
    if hm is not None:
        hm = torch.tensor(hm, device=dev)
    lengths = [256, 129, 40, 1] if opts.get("cap", 256) == 256 \
        else [2048, 1501, 900, 33]
    run_pair(dev, cfg, g, lengths, requant=opts.get("quant", True),
             v_keep=(40, 48), head_mask=hm, _skip_append=True, **flags)


# name -> (GQA group, lengths, call options): importance kinds and the
# split-K flags, f32 metadata, capacity 256
SPLIT_K_CASES = {
    "presoftmax_accumulated": (1, [256, 129, 40, 1],
                               dict(importance_kind="presoftmax")),
    "presoftmax_delta": (2, [256, 129, 40, 1],
                         dict(importance_kind="presoftmax", delta_mode=True)),
    "prob_delta": (1, [256, 129, 40, 1], dict(delta_mode=True)),
    "append_mask": (1, [256, 129, 40, 0],
                    dict(append_mask=[True, False, True, False],
                         delta_mode=True, return_row_stats=True)),
    "row_stats_dead_group": (2, [256, 129, 40, 1],
                             dict(return_row_stats=True,
                                  head_mask=[True, True, False, False])),
    "per_row_gqa": (4, [256, 129, 40, 0],
                    dict(per_row_importance=True, delta_mode=True,
                         return_row_stats=True,
                         append_mask=[False, True, False, False])),
    "per_row_gqa3": (3, [256, 129, 40, 0],
                     dict(per_row_importance=True, delta_mode=True,
                          return_row_stats=True,
                          append_mask=[False, True, False, False],
                          head_mask=[True, True, True, False, True, True])),
    # groups past 8 (two chunks of 8 rows in <8, 128>): per-row deltas,
    # row stats and the presoftmax sum over every row of both chunks
    "per_row_gqa16": (16, [256, 129, 40, 0],
                      dict(per_row_importance=True, delta_mode=True,
                           return_row_stats=True,
                           append_mask=[False, True, False, False],
                           head_mask=[i not in (3, 20) for i in range(32)])),
    "presoftmax_delta_gqa12": (12, [256, 200, 33, 2],
                               dict(importance_kind="presoftmax",
                                    delta_mode=True, return_row_stats=True,
                                    head_mask=[i != 9 for i in range(24)])),
}


@pytest.mark.parametrize("case", list(SPLIT_K_CASES))
def test_k1_split_k_flags_match_plain(dev, case):
    group, lengths, flags = SPLIT_K_CASES[case]
    cfg = serving_small(hq=2 * group, hkv=2, bf16=False)
    g = torch.Generator(device=dev).manual_seed(100 + len(case))
    flags = dict(flags)
    for k in ("append_mask", "head_mask"):
        if k in flags:
            flags[k] = torch.tensor(flags[k], device=dev)
    res = run_pair(dev, cfg, g, lengths, requant=True, v_keep=(40, 48),
                   **flags)
    assert res["max_abs_err"] <= 1e-4


# K1's tile ring at capacity 256 and head_dim 128: T = 64 rows per 8 KB
# tile (32 packed rows per 6-bit tile), pack unit U = 256.  Lengths 1,
# T-1, T, T+1 (and 31-33 for the 6-bit tile), U/2 and U/2+1 (the first
# lo token), and the full rung.
RING_LENGTHS = [1, 31, 32, 33, 63, 64, 65, 128, 129, 256]
RING_CASES = {
    "bits4": (dict(bf16=False), {}),
    "bits6": (dict(layer_bits=(4, 6)), {}),
    "bits8": (dict(layer_bits=(4, 8)), {}),
    "dense": (dict(quant=False), {}),
    "serving_flags": (dict(layer_bits=(4, 6)),
                      dict(quantize_queries=True, pv_int8=True,
                           probs_bf16=True)),
}


@pytest.mark.parametrize("case", list(RING_CASES))
def test_k1_ring_edges_match_plain(dev, case):
    opts, flags = RING_CASES[case]
    cfg = serving_small(hq=2, hkv=2, **opts)
    g = torch.Generator(device=dev).manual_seed(200 + len(case))
    res = run_pair(dev, cfg, g, RING_LENGTHS,
                   requant=opts.get("quant", True), v_keep=(40, 48), **flags)
    if not flags:                    # rounded weights have their own rule
        assert res["max_abs_err"] <= 1e-4


def test_k1_ring_requant_with_unkept_blocks(dev):
    """Every live group requantizes (threshold 1) while V pruning keeps 3
    of 16 blocks, so runs of whole blocks are never fetched."""
    cfg = serving_small(hq=2, hkv=2, bf16=False)
    g = torch.Generator(device=dev).manual_seed(301)
    res = run_pair(dev, cfg, g, [256, 200, 129, 65], requant=True,
                   threshold=1.0, v_keep=(40, 40))
    assert res["fired"] == 8 and res["max_abs_err"] <= 1e-4


def test_k1_ring_rows_without_append(dev):
    cfg = serving_small(hq=2, hkv=2, bf16=False)
    g = torch.Generator(device=dev).manual_seed(302)
    res = run_pair(dev, cfg, g, [65, 129, 64, 0], requant=True,
                   v_keep=(40, 48), delta_mode=True, return_row_stats=True,
                   append_mask=torch.tensor([False, True, False, False],
                                            device=dev))
    assert res["max_abs_err"] <= 1e-4


def test_k1_ring_gqa4_long_f32(dev):
    """GQA group 4 over 2048 tokens with f32 metadata."""
    cfg = serving_small(cap=2048, hq=8, hkv=2, bf16=False)
    g = torch.Generator(device=dev).manual_seed(303)
    res = run_pair(dev, cfg, g, [2048, 1999, 1025, 64], requant=True,
                   v_keep=(300, 300))
    assert res["max_abs_err"] <= 1e-4


def test_split_k_matches_unsharded_k1(dev):
    """Four shards on one card: K1 per shard and the exact recombination vs
    one unsharded K1 call over the globally packed cache of the same
    tokens; then a prune and one more step over the kept set."""
    _split_k_vs_unsharded(dev, hq=4, hkv=2)


def test_split_k_group3_matches_unsharded_k1(dev):
    """The same with GQA group 3 (6 query heads over 2 kv heads), which
    every shard's K1 call runs in <4, 64>."""
    _split_k_vs_unsharded(dev, hq=6, hkv=2)


def _split_k_vs_unsharded(dev, hq, hkv):
    n, b, d, cl = 4, 2, 64, 256
    cap = n * cl
    mesh = sk.make_kv_mesh([dev] * n)
    rng = np.random.default_rng(5)
    x = {k: torch.from_numpy(rng.standard_normal(sh).astype(np.float32)
                             ).to(dev)
         for k, sh in (("q", (b, hq, 1, d)), ("k", (b, hkv, cap, d)),
                       ("v", (b, hkv, cap, d)), ("kn", (b, hkv, 1, d)),
                       ("vn", (b, hkv, 1, d)))}
    imp0 = torch.from_numpy(rng.uniform(size=(b, hkv, cap)).astype(
        np.float32)).to(dev)
    ks = sk.quantize_sharded(x["k"], mesh)
    vs = sk.quantize_sharded(x["v"], mesh, with_msb=False)
    kg = qz.quantize(x["k"])
    vg = qz.quantize(x["v"], with_msb=False)
    own = torch.tensor([100, 37], dtype=torch.int32)
    local = torch.cat([torch.full((n - 1, b), cl, dtype=torch.int32),
                       own[None]]).to(dev)
    glob = local.sum(0)
    imp_s = sk.shard_tokens(imp0.clone(), mesh, -1)
    kw = dict(sm_scale=0.125, quant_enabled=True)
    before = fd.fused_decode_attention.launches
    out, ks, vs, imp_s, _, _ = sk.split_k_decode_fused(
        x["q"], ks, vs, x["kn"], x["vn"], local, mesh, importance_in=imp_s,
        **kw)
    assert fd.fused_decode_attention.launches == before + n
    imp_g = imp0.clone()
    want, _, kg, vg = fd.fused_decode_attention(
        x["q"], kg, vg, x["kn"], x["vn"], glob, importance_in=imp_g, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    joined = sk.join_kv(ks)
    assert torch.equal(joined.full, kg.full)
    imp = sk.join_tokens(imp_s)
    for bi in range(b):
        m = int(glob[bi])
        torch.testing.assert_close(imp[bi, :, :m], imp_g[bi, :, :m],
                                   atol=1e-5, rtol=1e-4)
    ks, vs, imp_s, local = sk.split_k_prune(
        ks, vs, imp_s, local, mesh, start_size=4, important_size=300,
        recent_size=100)
    assert local[:, 0].tolist() == [256, 148, 0, 0]
    local[1] += 1                               # the owner of slot 404
    out2, _, _, _, _, _ = sk.split_k_decode_fused(
        x["q"], ks, vs, x["kn"], x["vn"], local, mesh, **kw)
    kg2, vg2 = sk.join_kv(ks), sk.join_kv(vs)
    kg2 = kg2._replace(msb=qz.pack_msb(kg2.full))
    glob2 = local.sum(0)
    # the shards already hold the appended row: the unsharded call
    # rewrites the same bytes at the same slot
    want2, _, _, _ = fd.fused_decode_attention(
        x["q"], kg2, vg2, x["kn"], x["vn"], glob2, track_importance=False,
        **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out2, want2, atol=1e-4, rtol=1e-4)


def test_launch_probes_match_plain(dev):
    ops = lo.inputs(dev, seed=3)
    before = {pid: k.launches for pid, (k, _, _, _) in lo.PROBES.items()}
    errs = lo.check_probes(ops)
    assert errs == {pid: 0.0 for pid in lo.PROBES}
    assert all(k.launches == before[pid] + 1
               for pid, (k, _, _, _) in lo.PROBES.items())


def test_p2_partitions_the_block_exactly(dev):
    ops = lo.inputs(dev, seed=8)
    out = torch.full_like(ops["x"], float("nan"))
    got = lo.gridded(ops["x"], out=out)
    torch.cuda.synchronize()
    assert got is out and torch.equal(got, lo.gridded_plain(ops["x"]))


@pytest.mark.parametrize("fill", ["random", -128, 127])
def test_p3_sums_exactly(dev, fill):
    """P3 on random bytes and at both ends of int8: all -128 sums to
    -2^24, all 127 to 127 * 2^17; both exact in f32.  Rows 256-1023 hold
    other bytes, which must not count."""
    ops = lo.inputs(dev, seed=9)
    plane = ops["plane"]
    if fill != "random":
        plane[:256] = fill
    got = lo.dma(plane)
    want = lo.dma_plain(plane)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if fill == -128:
        assert float(got[0, 0]) == -2.0 ** 24
    elif fill == 127:
        assert float(got[0, 0]) == 127.0 * 2 ** 17


def test_p2_p3_refuse_misaligned_views(dev):
    ops = lo.inputs(dev, seed=10)
    xs = torch.zeros(8 * 128 + 4, device=dev)
    x_off = xs[1:1 + 8 * 128].view(8, 128)
    raw = torch.zeros(1024 * 512 + 16, dtype=torch.int8, device=dev)
    plane_off = raw[1:1 + 1024 * 512].view(1024, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.gridded(x_off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.gridded(ops["x"], out=x_off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.dma(plane_off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.dma(ops["plane"], out=x_off)


def test_p4_wraps_in_place_twice(dev):
    """P4 at the int8 wrap edges, applied twice to the same plane: rows
    0-7 equal the plain version's, rows 8-1023 keep their bytes."""
    ops = lo.inputs(dev, seed=5)
    plane = ops["plane"]
    plane[:8, 0::3] = 127
    plane[:8, 1::3] = -128
    plane[:8, 2::3] = -1
    before = plane.clone()
    want = plane.clone()
    for _ in range(2):
        got_o = lo.aliased(plane)
        want_o = lo.aliased_plain(want)
    torch.cuda.synchronize()
    assert torch.equal(got_o, want_o)
    assert torch.equal(plane, want)
    assert torch.equal(plane[8:], before[8:])
    assert int(plane[0, 0]) == -127 and int(plane[0, 2]) == 1


@pytest.mark.parametrize("scalar", [-7, 2 ** 20])
def test_p5_reads_the_scalar_on_the_card(dev, scalar):
    ops = lo.inputs(dev, seed=6)
    ops["s"][0] = scalar
    got = lo.spref(ops["s"], ops["x"])
    want = lo.spref_plain(ops["s"], ops["x"])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_p4_p5_refuse_misaligned_views(dev):
    ops = lo.inputs(dev, seed=7)
    raw = torch.zeros(1024 * 512 + 16, dtype=torch.int8, device=dev)
    plane = raw[1:1 + 1024 * 512].view(1024, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.aliased(plane)
    xs = torch.zeros(8 * 128 + 4, device=dev)
    x_off = xs[1:1 + 8 * 128].view(8, 128)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.spref(ops["s"], x_off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.spref(ops["s"], ops["x"], out=x_off)
    with pytest.raises(ValueError, match="16-byte aligned"):
        lo.aliased(ops["plane"], out=x_off)


def _generate_against_cpu(dev, cfg, batch, plen, new):
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.model.vocab_size,
                                               (batch, plen))
    return kc.check_against_cpu(cfg, params, prompt, new, dev)


@pytest.mark.parametrize("name", list(chip_smoke.gate_configs()))
def test_gate_sends_unsupported_shapes_off_k1(dev, name):
    """``generate`` on a configuration that the card's gate sends off K1
    (lane width not a multiple of 128): no K1 launch, no raise; each call
    within 1e-3 of its CPU replay, greedy tokens equal where the top-2
    margin is clear."""
    res = _generate_against_cpu(dev, *chip_smoke.gate_configs()[name])
    assert res["k1"] == 0 and res["prune_points"] > 0


@pytest.mark.parametrize("name", list(chip_smoke.group_configs()))
def test_group3_generate_through_k1(dev, name):
    """``generate`` on a GQA-3 model (6 query heads over 2 kv heads of
    64), which K1 runs in <4, 64> with 3 live rows: one launch per layer
    and step, each call within 1e-3 of its CPU replay."""
    cfg, batch, plen, new = chip_smoke.group_configs()[name]
    res = _generate_against_cpu(dev, cfg, batch, plen, new)
    assert res["k1"] == cfg.model.num_layers * new
    assert res["prune_points"] > 0


@pytest.mark.parametrize("name", list(chip_smoke.group_configs()))
def test_server_two_requests_through_k1(dev, name):
    """``SpAttenServer`` on the card with two requests (the GQA-3 model,
    two slots, prompts that prune in prefill): every forward call within
    1e-3 of its CPU replay, tokens equal where the top-2 margin is clear,
    budgets met, slots free, K1 once per layer and decode tick."""
    cfg, _, _, _ = chip_smoke.group_configs()[name]
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(0)
    requests = [(rng.integers(0, cfg.model.vocab_size, 72), 12),
                (rng.integers(0, cfg.model.vocab_size, 90), 7)]
    res = kc.check_server_against_cpu(cfg, params, requests, dev)
    assert res["k1"] == cfg.model.num_layers * res["steps"] > 0
    assert res["ticks"] > 0


@pytest.mark.parametrize("name", list(chip_smoke.device_scores_configs()))
def test_long_window_generate_through_k1(dev, name):
    """``generate`` on a GQA-8 model at capacity 4096, whose K1 score plane
    lies in device memory: K1 launches once per layer and step (checked
    inside), each call within 1e-3 of its CPU replay."""
    cfg, batch, plen, new = chip_smoke.device_scores_configs()[name]
    res = _generate_against_cpu(dev, cfg, batch, plen, new)
    assert res["k1"] == cfg.model.num_layers * new
    assert res["prune_points"] > 0


# name -> (query heads, kv heads, capacity, lengths): K1 with its [G, C]
# score plane in device memory, head_dim 128, v_block 16
DEVICE_SCORE_CASES = {
    "GQA 8, capacity 4096": (8, 1, 4096, [4096, 3001, 1500, 65]),
    "GQA 4, capacity 16384": (8, 2, 16384, [16384, 9001, 4097, 1]),
}


# GQA group -> {placement of the score plane: (query heads, kv heads,
# head_dim, capacity, lengths)}: K1 runs 3 in <4, D> and 5-7 in <8, D>,
# whose plan (the instance's) decides the placement; 4 kv heads where the
# partial head mask can kill a whole group
GROUP_CASES = {
    3: {"shared": (12, 4, 64, 256, [256, 129, 40, 1]),
        "device": (6, 2, 128, 8192, [8192, 4097, 65, 1])},
    5: {"shared": (20, 4, 128, 256, [256, 200, 33, 1]),
        "device": (10, 2, 128, 4096, [4096, 2049, 65, 1])},
    6: {"shared": (24, 4, 64, 256, [256, 129, 40, 1]),
        "device": (12, 2, 64, 4096, [4096, 3001, 65, 1])},
    7: {"shared": (28, 4, 128, 256, [256, 129, 64, 1]),
        "device": (7, 1, 128, 4096, [4096, 1500, 65, 1])},
}


@pytest.mark.parametrize("placement", ["shared", "device"])
@pytest.mark.parametrize("group", list(GROUP_CASES))
def test_k1_groups_in_larger_instances_match_plain(dev, group, placement):
    """K1 at the GQA groups it runs with padded rows, a partly alive group
    among them: in shared memory under the serving flags (bf16 metadata,
    int8 queries, pv_int8, probs_bf16), in device memory under f32
    metadata (out within 1e-4)."""
    hq, hkv, d, cap, lengths = GROUP_CASES[group][placement]
    inst = fd.instance_group(group)
    assert inst == (4 if group == 3 else 8)
    assert fd.scores_in_smem(inst, d, cap, 16) is (placement == "shared")
    hm = torch.ones((hkv, group), dtype=torch.bool)
    hm[-1, 0] = False                      # a partly alive group
    if hkv > 2:
        hm[1] = False                      # a dead group
    hm = hm.reshape(hq).to(dev)
    g = torch.Generator(device=dev).manual_seed(500 + 10 * group + cap)
    if placement == "shared":
        cfg = serving_small(cap=cap, hq=hq, hkv=hkv, d=d, bf16=True)
        flags = dict(quantize_queries=True, pv_int8=True, probs_bf16=True)
    else:
        cfg = serving_small(cap=cap, hq=hq, hkv=hkv, d=d, bf16=False)
        flags = {}
    res = run_pair(dev, cfg, g, lengths, requant=True,
                   v_keep=(cap // 4, cap // 4), head_mask=hm, **flags)
    assert res["dead_groups"] == (len(lengths) if hkv > 2 else 0)
    if not flags:
        assert res["max_abs_err"] <= 1e-4


# name -> (query heads, kv heads, head_dim, capacity, lengths): head dims
# K1 runs in a larger instance dim (100, 80 and 96 in <G, 128>, whose
# lanes past d hold the next head's bytes)
HEAD_DIM_CASES = {
    "OpenLLaMA-3B 100 (4 over 4)": (4, 4, 100, 256, [256, 129, 40, 1]),
    "80 (4 over 2, 6-bit)": (4, 2, 80, 256, [256, 200, 33, 2]),
    "96 (GQA 3, 6 over 2)": (6, 2, 96, 256, [256, 129, 64, 1]),
}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(HEAD_DIM_CASES))
def test_k1_head_dims_match_plain(dev, case, bf16):
    """K1 at head dims off its instances under the serving flags (bf16
    metadata) or f32 metadata (out within 1e-4), a partly alive group
    among them; every plane byte (the neighbouring heads' lanes
    included) equal to the plain version's."""
    hq, hkv, d, cap, lengths = HEAD_DIM_CASES[case]
    assert fd.instance_dim(d) == 128
    cfg = serving_small(cap=cap, hq=hq, hkv=hkv, d=d, bf16=bf16,
                        layer_bits=(4, 6) if "6-bit" in case else None)
    hm = torch.ones(hq, dtype=torch.bool)
    hm[-1] = False
    g = torch.Generator(device=dev).manual_seed(600 + d + hq)
    flags = (dict(quantize_queries=True, pv_int8=True, probs_bf16=True)
             if bf16 else {})
    res = run_pair(dev, cfg, g, lengths, requant=True, v_keep=(64, 64),
                   head_mask=hm.to(dev), **flags)
    if not bf16:
        assert res["max_abs_err"] <= 1e-4


# name -> (capacity, rung, v_block, lengths, bf16 metadata, layer bits):
# stored capacities and rungs off a multiple of 8 (pack units 1020 and
# 1500; columns of the scale and importance planes off 16 bytes)
CAPACITY_CASES = {
    "1020, v_block 4, bf16": (1020, 1020, 4, [1020, 1019, 511, 2], True,
                              None),
    "1020, v_block 4, f32": (1020, 1020, 4, [1020, 700, 509, 1], False,
                             None),
    "3000 at rung 1500, 6-bit": (3000, 1500, 60, [1500, 1499, 751, 3],
                                 True, (4, 6)),
}


@pytest.mark.parametrize("case", list(CAPACITY_CASES))
def test_k1_capacity_off_8_matches_plain(dev, case):
    """K1 at a stored capacity and rung off a multiple of 8, appending in
    the last rows of the plane and of its half-units."""
    cap, rung, vb, lengths, bf16, bits = CAPACITY_CASES[case]
    assert fd.k1_shape_error(2, 128, cap, rung, vb) is None
    cfg = serving_small(cap=cap, hq=4, hkv=2, d=128, bf16=bf16,
                        layer_bits=bits)
    cfg = dataclasses.replace(cfg, pruning=dataclasses.replace(
        cfg.pruning, v_block_size=vb))
    g = torch.Generator(device=dev).manual_seed(700 + cap + vb)
    flags = dict(cap_override=rung if rung < cap else None)
    if bf16:
        flags.update(quantize_queries=True, pv_int8=True, probs_bf16=True)
    res = run_pair(dev, cfg, g, lengths, requant=True,
                   v_keep=(rung // 4, rung // 4), **flags)
    if not bf16:
        assert res["max_abs_err"] <= 1e-4


@pytest.mark.parametrize("case", list(DEVICE_SCORE_CASES))
def test_k1_device_score_plane_matches_plain(dev, case):
    hq, hkv, cap, lengths = DEVICE_SCORE_CASES[case]
    assert not fd.scores_in_smem(hq // hkv, 128, cap, 16)
    cfg = serving_small(cap=cap, hq=hq, hkv=hkv, bf16=False)
    g = torch.Generator(device=dev).manual_seed(400 + hq + hkv)
    res = run_pair(dev, cfg, g, lengths, requant=True,
                   v_keep=(cap // 4, cap // 4))
    assert res["max_abs_err"] <= 1e-4


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


# name -> (query heads, kv heads, head_dim, capacity, lengths, layer
# bits): GQA groups past 8, which K1 runs in <8, D> as chunks of 8 rows
# of a device score plane
WIDE_GROUP_CASES = {
    "GQA 16 (32 over 2 x 128)": (32, 2, 128, 256, [256, 129, 40, 1], None),
    "GQA 12 (24 over 2 x 64), 6-bit": (24, 2, 64, 256, [256, 200, 33, 2],
                                       (4, 6)),
}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(WIDE_GROUP_CASES))
def test_k1_groups_past_8_match_plain(dev, case, bf16):
    """K1 at groups 16 and 12 with a partly alive group, under the serving
    flags (bf16 metadata, int8 queries, pv_int8, probs_bf16) or f32
    metadata (out within 1e-4)."""
    hq, hkv, d, cap, lengths, bits = WIDE_GROUP_CASES[case]
    plan = fd.k1_plan(hq // hkv, d, cap, 16)
    assert plan.inst == 8 and plan.rows == 16 and not plan.scores_in_smem
    cfg = serving_small(cap=cap, hq=hq, hkv=hkv, d=d, bf16=bf16,
                        layer_bits=bits)
    hm = torch.ones((hkv, hq // hkv), dtype=torch.bool)
    hm[-1, 0] = False
    hm[-1, 9] = False                       # a dead row in the 2nd chunk
    g = torch.Generator(device=dev).manual_seed(800 + hq + 7 * bf16)
    flags = (dict(quantize_queries=True, pv_int8=True, probs_bf16=True)
             if bf16 else {})
    res = run_pair(dev, cfg, g, lengths, requant=True, v_keep=(64, 64),
                   head_mask=hm.reshape(hq).to(dev), **flags)
    if not bf16:
        assert res["max_abs_err"] <= 1e-4


@pytest.mark.parametrize("case", list(chip_smoke.LONG_WINDOW_CASES))
def test_k1_long_windows_match_plain(dev, case):
    """K1 where its per-V-block arrays lie in device memory (1 kv head of
    group 8 at 65,536 tokens, 2 kv heads at 131,072), on inputs peaked on
    the kept count of blocks (``chip_smoke.peaked_k1_inputs``), every
    head requantizing."""
    hq, hkv, cap, vb, lengths = chip_smoke.LONG_WINDOW_CASES[case]
    base = chip_smoke.k1_shape_config(chip_smoke.serving_config(2, cap=cap),
                                      hq=hq, hkv=hkv, d=128, cap=cap)
    cfg = dataclasses.replace(
        base, quant=dataclasses.replace(base.quant, scale_dtype="float32"),
        pruning=dataclasses.replace(base.pruning, v_block_size=vb,
                                    importance_dtype="float32")).validate()
    assert not fd.k1_plan(hq // hkv, 128, cap, vb).blocks_in_smem
    kw = chip_smoke.k1_flags(cfg, 0, cap)
    kb = fd._v_keep_blocks(kw["v_keep"], vb, cap, 0)
    g = torch.Generator(device=dev).manual_seed(900 + hkv)
    st, q, kn, vn = chip_smoke.peaked_k1_inputs(cfg, dev, g, lengths, kb)
    res = kc.k1_pair(st, q, kn, vn,
                     torch.tensor(lengths, dtype=torch.int32, device=dev),
                     layer=0, threshold=1.0, v_block=vb,
                     keep_blocks_for=lambda _: kb, **kw)
    assert res["near_rows"] == 0 and res["fired"] == hkv * len(lengths)


def test_supervised_streams_equal_on_the_card(dev, tmp_path):
    """``generate_supervised`` on the GQA-3 gate model (f32, K1 in <4,
    64>): a probe that fails before the second window, and a run resumed
    from disk, give the uninterrupted run's tokens exactly."""
    from spatten_tpu_torch.engine.supervisor import generate_supervised
    cfg, batch, plen, _ = chip_smoke.group_configs()[chip_smoke.GQA3_NAME]
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device=dev)
    prompt = np.random.default_rng(0).integers(0, cfg.model.vocab_size,
                                               (batch, plen))
    before = fd.fused_decode_attention.launches
    want = generate_supervised(params, cfg, prompt, 24, str(tmp_path / "a"),
                               window=8, health=lambda: True, device=dev)
    assert fd.fused_decode_attention.launches - before == 2 * 24
    calls = iter([True, False])
    got = generate_supervised(params, cfg, prompt, 24, str(tmp_path / "b"),
                              window=8, health=lambda: next(calls, True),
                              device=dev)
    assert torch.equal(got, want)
    generate_supervised(params, cfg, prompt, 16, str(tmp_path / "c"),
                        window=8, health=lambda: True, device=dev)
    got = generate_supervised(None, cfg, prompt, 24, str(tmp_path / "c"),
                              window=8, health=lambda: True, resume=True,
                              device=dev)
    assert torch.equal(got, want)


def test_checkpoint_round_trip_of_a_card_state(dev, tmp_path):
    """A card state (bf16 scales and importance) and its params restore
    byte for byte on the card, and the next decode step from the copy
    equals the one from the original."""
    from spatten_tpu_torch.engine import checkpoint
    cfg, batch, plen, _ = chip_smoke.group_configs()[chip_smoke.GQA3_NAME]
    cfg = dataclasses.replace(
        cfg, quant=dataclasses.replace(cfg.quant, scale_dtype="bfloat16"),
        pruning=dataclasses.replace(cfg.pruning,
                                    importance_dtype="bfloat16")).validate()
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    prompt = np.random.default_rng(1).integers(0, cfg.model.vocab_size,
                                               (batch, plen))
    res = gen.generate(params, cfg, prompt, 8, device=dev)
    checkpoint.save(str(tmp_path / "s"), params, res.state,
                    extra={"token": res.tokens[:, -1]})
    p2, s2, extra = checkpoint.restore_with_extra(str(tmp_path / "s"), dev)
    a = res.state
    for x, y in zip(a.cache.k + a.cache.v + tuple(a[1:]),
                    s2.cache.k + s2.cache.v + tuple(s2[1:])):
        assert (x is None) == (y is None)
        if x is not None:
            assert y.device == x.device and y.dtype == x.dtype
            assert torch.equal(x, y)
    assert all(torch.equal(params["layers"][k], p2["layers"][k])
               for k in params["layers"])
    tok = extra["token"].to(dev)
    t1, _, _ = gen.decode_step(params, cfg, a.clone(), tok)
    t2, _, _ = gen.decode_step(p2, cfg, s2, tok)
    assert torch.equal(t1, t2)


# name -> (query heads, kv heads, head_dim, lengths): head dims past 256
# lanes, which K1 runs in <G, 256> as lane pieces
WIDE_HEAD_DIM_CASES = {
    "384 (4 over 2, 6-bit)": (4, 2, 384, [256, 200, 33, 2]),
    "512 (GQA 8, 8 over 1)": (8, 1, 512, [256, 129, 64, 1]),
    "1024 (1 over 1)": (1, 1, 1024, [256, 255, 40, 3]),
}


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("case", list(WIDE_HEAD_DIM_CASES))
def test_k1_head_dims_past_256_lanes_match_plain(dev, case, bf16):
    """K1 at head dims past 256 lanes under the serving flags (bf16
    metadata) or f32 metadata (out within 1e-4); every plane byte equal
    to the plain version's."""
    hq, hkv, d, lengths = WIDE_HEAD_DIM_CASES[case]
    assert fd.instance_dim(d) == 256 and fd.lane_pieces(d) > 1
    cfg = serving_small(cap=256, hq=hq, hkv=hkv, d=d, bf16=bf16,
                        layer_bits=(4, 6) if "6-bit" in case else None)
    g = torch.Generator(device=dev).manual_seed(700 + d + hq)
    flags = (dict(quantize_queries=True, pv_int8=True, probs_bf16=True)
             if bf16 else {})
    res = run_pair(dev, cfg, g, lengths, requant=True, v_keep=(64, 64),
                   **flags)
    if not bf16:
        assert res["max_abs_err"] <= 1e-4


def nccl_rank(rank, world, cfg, params, prompt, steps):
    """A 1-rank NCCL ``ShardedEngine`` fed its own greedy tokens: the
    tokens of its prefill and first ``steps - 1`` decode steps."""
    from spatten_tpu_torch.parallel import ShardedEngine, make_mesh
    mesh = make_mesh(cfg.engine.mesh)
    eng = ShardedEngine(cfg, mesh)
    p = eng.shard_params(params)
    state = eng.init_sharded_state(prompt.shape[0])
    x = prompt.to(mesh.device)
    chunk = cfg.engine.prefill_chunk
    for pos in range(0, x.shape[1], chunk):
        lg, state = eng.prefill_step()(p, state, x[:, pos:pos + chunk])
    tok = torch.argmax(lg, -1).to(torch.int32)
    out = [tok]
    for _ in range(steps - 1):
        tok, state = eng.decode_step()(p, state, tok)
        out.append(tok)
    return torch.distributed.get_backend(), torch.stack(out, 1).cpu()


def test_one_rank_nccl_sharded_engine_matches_generate(dev):
    """A ShardedEngine on a 1 x 1 mesh under NCCL (one card, one rank)
    gives ``generate``'s greedy tokens on the same f32 weights and
    prompt over its first window (no prune falls in it: the engine
    prunes step by step, ``generate`` at window boundaries)."""
    from pathlib import Path
    from spatten_tpu_torch.parallel import launch
    cfg = chip_smoke.mesh_small_config()
    steps = 8
    params = tr.init_params(cfg.model, 3, dtype=torch.float32, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.model.vocab_size, (4, 40)))
    [(backend, got)] = launch.spawn(
        "test_torch_cuda:nccl_rank", 1, cfg, params, prompt, steps,
        backend="nccl", path=[str(Path(__file__).parent)], timeout=300)
    assert backend == "nccl"
    on_card = {k: (v.to(dev) if torch.is_tensor(v) else
                   {n: t.to(dev) for n, t in v.items()})
               for k, v in params.items()}
    ref = gen.generate(on_card, cfg, prompt.to(dev), steps, device=dev)
    assert not ref.pruned_layers
    assert torch.equal(got, ref.tokens.cpu())


@pytest.mark.parametrize("rung", list(chip_smoke.ROUNDING_CASES))
def test_k1_70b_shard_stages_bit_equal_plain(dev, rung):
    """One layer at Llama-2-70B's TP-4 shard instance (16 query heads over
    2 kv heads of 128, <8, 128, false>, batch 4) under the serving flags:
    scores, row max and denominator, probabilities, max prob, V-block keep
    masks, importance and out equal the plain version's bit for bit,
    since the plain version sums in the kernel's order."""
    cfg = chip_smoke.k1_shape_config(chip_smoke.serving_config(2), hq=16,
                                     hkv=2, d=128, cap=4096)
    gen_ = torch.Generator(device=dev).manual_seed(rung)
    lengths = chip_smoke.ROUNDING_CASES[rung]
    st, q, kn, vn = chip_smoke.k1_inputs(cfg, dev, gen_, len(lengths))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    kw = chip_smoke.k1_flags(cfg, 0, rung)
    vb = cfg.pruning.v_block_size
    rep = kc.k1_stages(st, q, kn, vn, lens, layer=0, threshold=0.0,
                       v_block=vb, keep_blocks=fd._v_keep_blocks(
                           kw["v_keep"], vb, rung, 0), **kw)
    for name in ("scores", "m", "den", "probs", "max_prob", "importance",
                 "out"):
        assert rep[name]["exact"] == rep[name]["total"] > 0, (name, rep)
    assert rep["keep"]["flips"] == 0


def test_ppl_curve_at_gpt2s_widths_on_the_card(dev):
    """The perplexity tool at GPT-2 small's widths cut to 2 layers on a
    tiny corpus: a few training steps, then the rows evaluated through
    the kernels (K1 at a one-token chunk: 2 x 511 launches), finite."""
    from spatten_tpu_torch.tools import ppl_curve as pc
    sc = pc.SCALES["gpt2s"]
    sc = dataclasses.replace(sc, model=dataclasses.replace(sc.model,
                                                          num_layers=2))
    rng = np.random.default_rng(0)
    text = " ".join(rng.choice(["the", "row", "of", "a", "cache", "keeps",
                                "its", "scale"], 20000))
    corpus = pc.Corpus(np.frombuffer(text.encode(), dtype=np.uint8))
    params = pc.train(5, sc, corpus, dev, log=lambda s: None)
    text_ids, _ = pc.eval_texts(sc, corpus)
    base = dict(pc.configs(sc))["spatten keep~0.50 (4b+requant+vprune)"]
    cfg = dataclasses.replace(base, engine=dataclasses.replace(
        base.engine, prefill_chunk=1))
    fd.fused_decode_attention.launches = 0
    from spatten_tpu_torch.eval import evaluate_perplexity
    r = evaluate_perplexity(params, cfg, text_ids, device=dev)
    assert math.isfinite(r.perplexity) and r.num_tokens == 511
    assert fd.fused_decode_attention.launches == 2 * 511


def latent_chat_cfg():
    """``chat_like_cfg``'s knobs on a 2-layer DeepSeek-V2 at the latent
    row's published lanes (512 + 64; nope and v 128; 4 heads, hidden 256;
    layer 0 dense, layer 1 with 8 experts of 64, top 2, 1 shared)."""
    from spatten_tpu_torch.config import DeepseekV2Config
    base = chat_like_cfg()
    model = DeepseekV2Config(
        vocab_size=256, hidden_size=256, num_layers=2, num_heads=4,
        num_kv_heads=4, head_dim=192, intermediate_size=512,
        norm_eps=1e-6, kv_lora_rank=512, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, yarn_factor=40.0,
        yarn_mscale=0.707, yarn_mscale_all_dim=0.707, n_routed_experts=8,
        num_experts_per_tok=2, moe_intermediate_size=64, n_shared_experts=1)
    return dataclasses.replace(
        base, model=model, pruning=dataclasses.replace(base.pruning,
                                                       head_keep=3)
    ).validate()


def chat_like_cfg():
    """The chat cell's serving knobs (``portbench/configs/deepseek-llm-7b-
    chat.json``: MHA heads of 128, capacity rungs, head pruning, V
    pruning, int8 queries and P·V, bf16 scales and importance) on a
    2-layer model of 2 heads, capacity 256, 16-token prefill chunks."""
    return SpAttenConfig(
        model=ModelConfig(vocab_size=256, hidden_size=256, num_layers=2,
                          num_heads=2, num_kv_heads=2, head_dim=128,
                          intermediate_size=512),
        pruning=PruningConfig(
            start_size=4, important_size=140, recent_size=25,
            cascade_layer_ratios=(1.0, 0.78), enable_v_pruning=True,
            v_keep_ratio=0.25, v_block_size=16, enable_head_pruning=True,
            head_keep=1, head_update_interval=32,
            importance_dtype="bfloat16"),
        quant=QuantConfig(enabled=True, enable_requant=True,
                          requant_threshold=0.05, quantize_queries=True,
                          pv_int8=True, probs_bf16=True,
                          scale_dtype="bfloat16"),
        engine=EngineConfig(max_batch_size=4, cache_capacity=256,
                            prefill_chunk=16, use_pallas=True,
                            rope_mode="cached", layer_cap_rungs=True,
                            layer_cap_headroom=64),
    ).validate()


def test_server_tick_syncs_all_traced(dev):
    """One ``SpAttenServer.step`` on the card that starts two admissions,
    runs their prefill chunks (one full-length, from the prefill graph
    captured in an earlier tick; one ragged, eager), finishes them (first
    token, ``write_slot``) and runs a decode step over the slot already
    active, under ``torch.cuda.set_sync_debug_mode("warn")``: every
    synchronising operation torch reports lies in a ``sync.*`` span of
    the tracer, and every such span holds exactly one."""
    cfg = chat_like_cfg()
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    server_tick_syncs_all_traced(cfg, params, dev)


def test_server_tick_syncs_all_traced_latent(dev):
    """``test_server_tick_syncs_all_traced`` on a DeepSeek-V2 model
    (``latent_chat_cfg``: the latent cache through K1, a dense layer and
    an expert layer): the attention's latent projections and the expert
    layer's router, sort and grouped GEMMs add no sync site."""
    cfg = latent_chat_cfg()
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    server_tick_syncs_all_traced(cfg, params, dev)


def server_tick_syncs_all_traced(cfg, params, dev):
    """The body of ``test_server_tick_syncs_all_traced`` for ``cfg``."""
    import time
    import traceback
    import warnings

    from spatten_tpu_torch.engine.server import SpAttenServer
    from spatten_tpu_torch.utils.profiling import tracer

    srv = SpAttenServer(params, cfg, device=dev)
    srv.submit(np.arange(20) % 251, max_new_tokens=8)
    srv.step()                        # the first chunk of two (captured)
    srv.step()                        # the second; the first decode
    srv.submit(np.arange(12) * 7 % 251, max_new_tokens=4)
    srv.submit(np.arange(16) * 5 % 251, max_new_tokens=4)
    torch.cuda.synchronize()
    seen = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" in str(message):
            seen.append((time.perf_counter_ns(),
                         "".join(traceback.format_stack(limit=8)[:-1])))

    tracer.drain()
    tracer.enable()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                srv.step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        tracer.disable()
        spans = tracer.drain()
    names = [s.name for s in spans]
    assert "server.write_slot" in names and "engine.decode" in names
    assert names.count("engine.prefill_replay") == 1
    assert "engine.prefill_capture" not in names
    syncs = [s for s in spans if s.name.startswith("sync.")]
    held = [0] * len(syncs)
    loose = []
    for t, stack in seen:
        inside = [i for i, s in enumerate(syncs) if s.t0 <= t <= s.t1]
        if inside:
            held[inside[0]] += 1
        else:
            loose.append(stack)
    assert not loose, "syncs outside every sync.* span:\n" + \
        "\n----\n".join(loose)
    assert len(seen) == len(syncs) and set(held) == {1}, \
        [(s.name, n) for s, n in zip(syncs, held)]


def chat_geometry_cfg(layers: int):
    """The chat cell's configuration (``portbench/configs/deepseek-llm-
    7b-chat.json`` through the harness's ``program_config``: 32 heads of
    128, hidden 4096, MLP 11008, vocab 102400, capacity 2048, chunks of
    128) cut to ``layers`` layers."""
    import json
    from pathlib import Path

    from portbench import manifest
    path = (Path(__file__).resolve().parents[1] / "portbench" / "configs"
            / "deepseek-llm-7b-chat.json")
    c = json.loads(path.read_text())
    c["num_hidden_layers"] = layers
    return manifest.path(c).program_config(c)


def state_fields(state) -> dict:
    """Every tensor of a decode state by name."""
    out = {f"k.{n}": x for n, x in state.cache.k._asdict().items()
           if x is not None}
    out.update({f"v.{n}": x for n, x in state.cache.v._asdict().items()
                if x is not None})
    out.update({n: getattr(state, n) for n in state._fields
                if n != "cache"})
    return out


def chunks_bit_equal(params, cfg, prompts, dev):
    """Run the prompts' chunks in turns (one chunk of each prompt in turn,
    as the server interleaves its admissions) eagerly and through one
    ``PrefillGraph``: every field of each state, the last logits and the
    aux equal bit for bit after every chunk; the input's layer lengths
    are never written and the returned lengths are new tensors.  Returns
    (graphed chunks, chunks)."""
    from spatten_tpu_torch.engine.prefill_graph import PrefillGraph
    runner = PrefillGraph(params, cfg)
    chunk = cfg.engine.prefill_chunk
    eager = [init_state(cfg, 1, device=dev) for _ in prompts]
    graphed = [init_state(cfg, 1, device=dev) for _ in prompts]
    calls = 0
    for pos in range(0, max(p.shape[1] for p in prompts), chunk):
        for i, p in enumerate(prompts):
            ids = p[:, pos:pos + chunk]
            if ids.shape[1] == 0:
                continue
            want = gen.prefill_chunk(params, cfg, eager[i], ids)
            before = graphed[i].layer_lengths.clone()
            got = gen.prefill_chunk(params, cfg, graphed[i], ids,
                                    graph=runner)
            calls += 1
            assert torch.equal(graphed[i].layer_lengths, before)
            eager[i], graphed[i] = want[1], got[1]
            assert torch.equal(got[0], want[0]), (i, pos)
            for x, y in zip(got[2], want[2]):
                assert (x is None and y is None) or torch.equal(x, y), \
                    (i, pos)
            fa, fb = state_fields(got[1]), state_fields(want[1])
            for name in fb:
                assert torch.equal(fa[name], fb[name]), (i, pos, name)
            if runner.out is not None:
                owned = {x.data_ptr() for x in runner.out if x is not None}
                assert not owned & {got[1].lengths.data_ptr(),
                                    got[1].layer_lengths.data_ptr(),
                                    got[0].data_ptr()}
    return runner.replays, calls


def test_prefill_graph_chunk_bit_equal_to_eager(dev):
    """At the chat cell's widths and knobs (2 layers, bf16 weights): three
    full chunks and a ragged one of a prompt, from the prefill graph (the
    first captures) and eagerly, bit for bit on every plane, scale,
    importance, both lengths, the requant count, the last logits and the
    aux; the ragged chunk runs eagerly."""
    cfg = chat_geometry_cfg(2)
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.model.vocab_size, (1, 3 * 128 + 57),
                        generator=g, device=dev, dtype=torch.int32)
    assert chunks_bit_equal(params, cfg, [ids], dev) == (3, 4)


def test_prefill_graph_interleaves_admissions_and_prunes(dev):
    """Two admissions interleaved through the one staging state, past
    the capacity (prunes before their late chunks), on
    ``chat_like_cfg()``: every chunk bit-equal to the eager path; then a
    server with the graph gives the tokens of one without it."""
    from spatten_tpu_torch.engine.server import SpAttenServer
    from spatten_tpu_torch.pruning import token_pruning
    cfg = chat_like_cfg()
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    lengths = (20 * 16, 17 * 16 + 9)
    assert max(lengths) > max(token_pruning.layer_capacities(cfg))
    prompts = [torch.randint(0, cfg.model.vocab_size, (1, n), generator=g,
                             device=dev, dtype=torch.int32)
               for n in lengths]
    graphed, calls = chunks_bit_equal(params, cfg, prompts, dev)
    assert (graphed, calls) == (37, 38)

    requests = [(p[0].cpu().numpy(), 6) for p in prompts] + [
        (np.arange(16 * k + 3) % 251, 4) for k in (1, 3, 5)]
    tokens = []
    for with_graph in (True, False):
        srv = SpAttenServer(params, cfg, device=dev)
        if not with_graph:
            srv.prefill_graph = None
        for p, n in requests:
            srv.submit(p, n)
        done = srv.run_to_completion()
        tokens.append({r.request_id: r.generated for r in done})
        if with_graph:
            assert srv.prefill_graph.replays == 37 + 1 + 3 + 5
    assert tokens[0] == tokens[1]


def test_prefill_graph_latent_chunk_bit_equal_to_eager(dev):
    """DeepSeek-V2-Lite's widths and the cell's knobs at 2 layers (layer 0
    dense, layer 1 with 64 experts), bf16 weights: three full chunks and a
    ragged one of a prompt, from the prefill graph (the latent
    projections, K1-free prefill attention at one kv head of group 16,
    the router, the sort and the grouped GEMMs captured) and eagerly, bit
    for bit."""
    cfg = chip_smoke.latent_config(2, 1)
    params = tr.init_params(cfg.model, 0, dtype=torch.bfloat16, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    ids = torch.randint(0, cfg.model.vocab_size, (1, 3 * 128 + 57),
                        generator=g, device=dev, dtype=torch.int32)
    assert chunks_bit_equal(params, cfg, [ids], dev) == (3, 4)


def test_k1_latent_shape(dev):
    """K1 at the latent shape (``chip_smoke.phase_k1_latent``: batch 128,
    one kv head of 576 lanes, group 16, capacity 2048 and both rungs of
    capacity 4096, the serving flags, per-row importance) matches its
    plain version in its latent instance, and so do the instance's 4-,
    6- and 8-bit layers and f32 scales, and a row-stats call in <8, 256>."""
    res = chip_smoke.phase_k1_latent(dev)
    assert set(res) == {"2048/2048", "4096/4096", "4096/2048",
                        "4/6/8-bit profile/0", "4/6/8-bit profile/1",
                        "4/6/8-bit profile/2", "f32 scales/0", "row stats"}


def test_grouped_gemm_against_loop(dev):
    """The expert layer's grouped GEMMs in bf16 on the card
    (``chip_smoke.phase_grouped_gemm``) against the loop over experts, at
    128 tokens and at 5 (idle experts), and replayed from a CUDA graph
    bit-equal to eager."""
    res = chip_smoke.phase_grouped_gemm(dev)
    assert res["graph_equal"] and res["tokens_5"]["idle_experts"] > 0


def test_server_latent_launches_k1_every_layer(dev):
    """``SpAttenServer`` at DeepSeek-V2-Lite's widths on 2 layers
    (``chip_smoke.phase_server_latent``): every request meets its budget
    and K1 launches once per layer and single-token call (decode ticks
    and one-token admission chunks), each in its latent instance, with
    the full-length admission chunks from the prefill graph."""
    res = chip_smoke.phase_server_latent(dev)
    assert res["ticks"] > 0 and res["single_chunks"] > 0
    assert res["k1"] == 2 * (res["ticks"] + res["single_chunks"])
    assert res["latent"] == res["k1"]
    assert res["graphed"] >= 1
