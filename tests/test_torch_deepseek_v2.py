"""DeepSeek-V2 on the port's serving path, on the CPU at a tiny size:
multi-head latent attention (one latent row a token, K1 at one kv head of
group ``num_heads``), YaRN, routed experts on grouped GEMMs, and the
plain reference ``portbench/reference/deepseek_v2_ref.py`` that decides
the benchmark cell's ``correct``.

The tiny model: 3 layers (1 dense, 2 with 8 experts, top 2, 1 shared),
4 heads, a latent of 32 lanes plus 8 rope lanes, nope 16 and v 16, YaRN
as DeepSeek-V2-Lite publishes it.  ``tests/test_torch_cuda.py`` runs the
latent shape and the grouped GEMM on the card.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine import prefill_graph as pg
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import moe, transformer
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.utils.profiling import tracer
from portbench import harness, manifest
from portbench.reference import deepseek_v2_ref as ref_mod
from portbench.tests import tiny

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CELL_CONFIG = ROOT / "portbench" / "configs" / "deepseek-v2-lite.json"
PLAIN = {"quantize_queries": False, "pv_int8": False, "probs_bf16": False,
         "scale_dtype": "float32", "importance_dtype": "float32"}


def tiny_config(plain: bool) -> dict:
    """The cell's config file at the tiny model's sizes; ``plain``: the
    serving flags the reference leaves to the program's precision off,
    f32 scales and importance, no quantized first pass."""
    c = json.loads(CELL_CONFIG.read_text())
    c.update(hidden_size=32, num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=4, kv_lora_rank=32, qk_rope_head_dim=8,
             qk_nope_head_dim=16, v_head_dim=16, intermediate_size=64,
             moe_intermediate_size=16, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1, vocab_size=256,
             max_position_embeddings=512)
    c["spatten"].update(start_size=2, important_size=12, recent_size=16,
                        v_block_size=8, head_keep=3, head_update_interval=8)
    # decode windows of one step: a prune lands at the step that would
    # overflow, as the server's decode step prunes and the reference does
    c["engine"].update(max_batch_size=2, cache_capacity=48, prefill_chunk=8,
                       decode_window=1, layer_cap_headroom=8,
                       param_dtype="float32")
    if plain:
        c["spatten"].update(PLAIN, quant_enabled=False,
                            enable_head_pruning=False)
    return c


def program_and_reference(c: dict, seed: int):
    path = manifest.path(c)
    cfg = path.program_config(c)
    params = path.make_params(c, seed, "cpu", torch.float32)
    ref = ref_mod.Reference(ref_mod.Knobs.from_config(c), params, "cpu")
    return cfg, params, ref


def served_logits(params, cfg, prompt: torch.Tensor, new: int):
    """``generate`` on the CPU: the prompt's last logits, every decode
    step's logits and the head mask in force at it, the tokens, the
    prune points."""
    seen, masks = [], []
    fwd = transformer.forward

    def spy(p, cfg_, state, tokens, **kw):
        if tokens.shape[1] == 1:
            masks.append(state.head_mask.clone())
        out = fwd(p, cfg_, state, tokens, **kw)
        seen.append((tokens.shape[1], out[0][:, -1].clone()))
        return out

    transformer.forward = spy
    try:
        res = gen.generate(params, cfg, prompt, new, device="cpu")
    finally:
        transformer.forward = fwd
    prefill = [lg for s, lg in seen if s > 1]
    decode = [lg for s, lg in seen if s == 1]
    return prefill[-1][0], decode, masks, res


# tolerances on |logit - reference logit| (max over every judged logit,
# mean over the steps of each step's largest), logits of order 1-3:
# - plain: f32 throughout, the int8 rows read in full, f32 scales and
#   importance: the two differ only in f32 rounding (absorbed vs per-head
#   up-projected keys, sums in another order): measured 7e-6, so 1e-4;
# - serving: the cell's knobs on f32 weights.  The int8 queries and the
#   8-bit P.V weights, which the reference leaves to the program's
#   precision, each alone give a largest gap of 1.6 and a mean of
#   0.14-0.17 at this tiny width (hidden 32, 4 heads), and together 1.1
#   and 0.17; rope lanes left interleaved, or the softmax scale without
#   YaRN's mscale, give means of 3.1 and 1.9.  So max 2.0, mean 0.3.
CASES = {"plain": (True, 1e-4, 1e-4), "serving": (False, 2.0, 0.3)}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_then_decode_matches_reference(case):
    """The program's prefill, then decode through its cache (prunes
    included: 30 prompt tokens and 30 new ones over a capacity of 48),
    against the reference's prefill and decode on the same tokens and
    head masks, logits compared at every step."""
    plain, tol_max, tol_mean = CASES[case]
    c = tiny_config(plain)
    cfg, params, ref = program_and_reference(c, 7)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (1, 30)).astype(np.int64))
    last, decode, masks, res = served_logits(params, cfg, prompt, 30)
    assert res.pruned_layers, "the run should prune"
    cache = ref_mod.Cache(ref.k, 1, "cpu")
    with torch.no_grad():
        gaps = [float((ref.prefill(cache, prompt[0]) - last).abs().max())]
        for j, lg in enumerate(decode):
            want = ref.decode_step(cache, res.tokens[0, j:j + 1],
                                   masks[j][None])
            gaps.append(float((want[0] - lg[0]).abs().max()))
    assert max(gaps) <= tol_max, gaps
    assert sum(gaps) / len(gaps) <= tol_mean, gaps


def test_absorbed_decode_equals_non_absorbed():
    """One decode step from the program's own cache: the program's
    absorbed attention (W_UK in the query, W_UV after) and the reference's
    per-head up-projected keys and values give the same logits."""
    c = tiny_config(plain=True)
    cfg, params, ref = program_and_reference(c, 5)
    state = init_state(cfg, batch=2, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 16)).astype(np.int64))
    logits, state, _ = gen.prefill(params, cfg, state, ids)[:3]
    cache = ref_mod.Cache(ref.k, 2, "cpu")
    k = ref.k
    for l in range(k.layers):
        kq = state.cache.k.full[l].to(torch.float32)          # [B, C, W]
        ks = state.cache.k.scale[l][:, 0]                     # [B, C]
        cache.kq[l][:] = state.cache.k.full[l]
        cache.ksc[l][:] = ks
        cache.kfull[l][:] = kq * ks[..., None]
        cache.kmsb[l][:] = cache.kfull[l]
        cache.vfull[l][:] = state.cache.v.full[l].to(torch.float32) \
            * state.cache.v.scale[l][:, 0, :, None]
        cache.imp[l][:] = state.importance[l]
    cache.lens[:] = state.layer_lengths.numpy()
    cache.lens_dev[:] = state.layer_lengths.to(torch.int64)
    tok = torch.tensor([3, 77])
    mask = torch.ones((2, k.layers, k.heads), dtype=torch.bool)
    with torch.no_grad():
        want = ref.decode_step(cache, tok, mask)
        got, _, _ = transformer.forward(params, cfg, state,
                                        tok.to(torch.int32)[:, None])
    torch.testing.assert_close(got[:, -1], want, rtol=0, atol=1e-4)


def test_yarn_frequencies_and_softmax_scale():
    """DeepSeek-V2-Lite's YaRN (factor 40 over 4,096 positions, beta_fast
    32, beta_slow 1, 64 rope lanes at theta 1e4): the correction range is
    lanes 10 to 23 (floor(10.47), ceil(22.52)); below it the plain
    frequencies, above it those over 40, a linear ramp between.  The
    softmax scale 192^-0.5 * (0.1 * 0.707 * ln 40 + 1)^2 = 0.114721;
    the tables' mscale is 1."""
    c = json.loads(CELL_CONFIG.read_text())
    m = manifest.path(c).program_config(c).model
    got = rope_ops.model_inv_freq(m, "cpu").double()
    plain = [10000.0 ** (-2 * i / 64) for i in range(32)]
    want = []
    for i in range(32):
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want.append(plain[i] / 40 * ramp + plain[i] * (1 - ramp))
    # a few written out: lane 0, the ramp's ends and middle, the last
    assert want[0] == 1.0
    assert math.isclose(want[10], 10000 ** (-20 / 64), rel_tol=1e-12)
    assert math.isclose(want[10], 0.0562341325, rel_tol=1e-8)
    assert math.isclose(want[16], 0.01 * (7 / 13 + 6 / 13 / 40),
                        rel_tol=1e-12)          # 0.0055
    assert math.isclose(want[23], 3.3338036e-05, rel_tol=1e-7)
    assert math.isclose(want[31], 3.3338036e-06, rel_tol=1e-7)
    torch.testing.assert_close(got, torch.tensor(want, dtype=torch.float64),
                               rtol=1e-6, atol=0)
    ref_freq = ref_mod.Knobs.from_config(c).inv_freq("cpu").double()
    torch.testing.assert_close(ref_freq, got, rtol=1e-6, atol=0)
    assert math.isclose(m.softmax_scale, 0.11472138679, rel_tol=1e-9)
    assert math.isclose(ref_mod.softmax_scale(c), 0.11472138679,
                        rel_tol=1e-9)
    cos, sin = rope_ops.model_rope_table(m, 16, "cpu")
    assert cos.shape == (16, 64)
    torch.testing.assert_close(cos[5, :32], torch.cos(5 * got.float()))


def test_forced_prune_compacts_latent_rows():
    """A prune forced on one layer: the compacted latent rows, scales and
    importance rows equal the reference's ``prune_layer`` from the same
    cache; a moved row keeps its latent lanes (to one int8 step of its
    new scale) and only its rope lanes turn by the slot delta."""
    c = tiny_config(plain=False)
    c["spatten"]["importance_dtype"] = "float32"
    cfg, params, ref = program_and_reference(c, 9)
    state = init_state(cfg, batch=1, device="cpu")
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 40)).astype(np.int64))
    _, state, _, pruned = gen.prefill(params, cfg, state, ids)
    assert not pruned
    l = 1
    k = ref.k
    cache = ref_mod.Cache(k, 1, "cpu")
    kq8 = state.cache.k.full[l, 0].clone()
    ksc = state.cache.k.scale[l, 0, 0].to(torch.float32).clone()
    cache.kq[l][0] = kq8
    cache.ksc[l][0] = ksc
    cache.kfull[l][0] = kq8.float() * ksc[:, None]
    cache.kmsb[l][0] = cache.kfull[l][0]
    cache.vfull[l][0] = state.cache.v.full[l, 0].float() \
        * state.cache.v.scale[l, 0, 0].float()[:, None]
    cache.imp[l][0] = state.importance[l, 0].float()
    cache.lens[l, 0] = int(state.layer_lengths[l, 0])
    before = cache.kfull[l][0].clone()
    state, _ = gen.maybe_prune(cfg, state, 40, static_layers=(l,))
    ref_mod.prune_layer(k, cache, l, [0], ref.inv_freq)
    n = int(state.layer_lengths[l, 0])
    assert n == cache.lens[l, 0] < 40
    torch.testing.assert_close(state.cache.k.full[l, 0, :n], cache.kq[l][0, :n],
                               rtol=0, atol=1)
    sc = state.cache.k.scale[l, 0, 0, :n].float()
    torch.testing.assert_close(sc, cache.ksc[l][0, :n], rtol=1e-6, atol=0)
    torch.testing.assert_close(state.importance[l, 0, :, :n].float(),
                               cache.imp[l][0, :, :n], rtol=0, atol=0)
    torch.testing.assert_close(
        state.cache.v.full[l, 0, :n].float()
        * state.cache.v.scale[l, 0, 0, :n].float()[:, None],
        cache.vfull[l][0, :n], rtol=0, atol=0)
    # a moved row: latent lanes as they were, rope lanes turned
    r = k.rank
    after = state.cache.k.full[l, 0, :n].float() * sc[:, None]
    moved = [j for j in range(n) if not torch.equal(after[j], before[j])]
    assert moved
    for j in moved:
        src = next(i for i in range(40) if i >= j and torch.allclose(
            before[i, :r], after[j, :r], atol=float(sc[j]) * 1.01,
            rtol=0))
        turned = ref_mod.rotate(before[src, r:], torch.tensor(
            float(j - src)), ref.inv_freq)
        torch.testing.assert_close(after[j, r:], turned, rtol=0,
                                   atol=float(sc[j]) * 1.01)


DISPATCH_CASES = {
    "five tokens, idle experts": (5, 8, 2, 0),
    "one token": (1, 8, 2, 1),
    "37 tokens, top 3": (37, 8, 3, 2),
    "bf16, 12 tokens": (12, 8, 2, 3),
}


@pytest.mark.parametrize("case", list(DISPATCH_CASES))
def test_grouped_dispatch_equals_loop(case):
    """``moe.experts`` (sorted rows, grouped GEMMs, ``index_copy_``
    combine) equals the plain loop over experts, experts that receive no
    token included; the offsets count every pick once."""
    t, n_exp, k, seed = DISPATCH_CASES[case]
    dt = torch.bfloat16 if case.startswith("bf16") else torch.float32
    g = torch.Generator().manual_seed(seed)
    d, inter = 16, 8
    h = torch.randn(t, d, generator=g).to(dt)
    wgu = (torch.randn(n_exp, 2 * inter, d, generator=g) / 4).to(dt)
    wd = (torch.randn(n_exp, d, inter, generator=g) / 3).to(dt)
    router = torch.randn(d, n_exp, generator=g)
    w, idx = moe.route(h, router, k)
    got, offs = moe.experts(h, wgu, wd, w, idx)
    want = moe.experts_loop(h, wgu, wd, w, idx)
    hits = moe.counts(offs)
    assert int(hits.sum()) == t * k
    assert hits.tolist() == torch.bincount(idx.reshape(-1),
                                           minlength=n_exp).tolist()
    if t * k < n_exp:
        assert (hits == 0).any()
    tol = dict(rtol=1e-2, atol=1e-2) if dt == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, want, **tol)


class _EagerReplay:
    """A captured graph's stand-in on the CPU: its replay runs the same
    forward eagerly on the staging state and writes the outputs."""

    def __init__(self, runner):
        self.runner = runner

    def replay(self):
        for dst, src in zip(self.runner.out, self.runner.forward()):
            if dst is not None:
                dst.copy_(src)


def _capture_on_cpu(runner, tokens):
    runner.staging = init_state(runner.cfg, 1, device=tokens.device)
    runner.ids = torch.zeros_like(tokens)
    runner.out = runner.forward()
    runner.graph = _EagerReplay(runner)


@pytest.mark.parametrize("traced", [False, True])
def test_prefill_graph_replays_the_tiny_model_bit_equal(monkeypatch,
                                                        traced):
    """Three full-length chunks through the prefill graph's runner equal
    the eager chunks bit for bit (last logits, every state field); with
    the tracer on, each replay notes the expert layers' row counts
    (``moe.experts_hit``), equal to the eager layers' counts.  (The
    captured graph itself runs on the card: ``tests/test_torch_cuda.py``.)
    """
    engages = pg.engages
    monkeypatch.setattr(pg, "engages",
                        lambda cfg, dt, shape: engages(cfg, "cuda", shape))
    monkeypatch.setattr(pg.PrefillGraph, "capture", _capture_on_cpu)
    c = tiny_config(plain=False)
    cfg, params, _ = program_and_reference(c, 4)
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (1, 24)).astype(np.int64))
    runner = pg.PrefillGraph(params, cfg)
    eager = init_state(cfg, 1, device="cpu")
    graphed = init_state(cfg, 1, device="cpu")
    tracer.drain()
    if traced:
        tracer.enable()
    try:
        for i in range(3):
            chunk = ids[:, 8 * i:8 * (i + 1)]
            want = gen.prefill_chunk(params, cfg, eager, chunk)
            got = gen.prefill_chunk(params, cfg, graphed, chunk,
                                    graph=runner)
            assert torch.equal(got[0], want[0])
            eager, graphed = want[1], got[1]
            for name in ("lengths", "layer_lengths", "importance",
                         "head_mask"):
                assert torch.equal(getattr(graphed, name),
                                   getattr(eager, name)), name
            for a, b in zip(graphed.cache.k + graphed.cache.v,
                            eager.cache.k + eager.cache.v):
                assert (a is None and b is None) or torch.equal(a, b)
    finally:
        tracer.disable()
        spans = tracer.drain()
    assert runner.replays == 3
    replays = [s for s in spans if s.name == "engine.prefill_replay"]
    if not traced:
        assert not spans
        return
    layers = [s for s in spans if s.name == "moe.layer"
              and s.parent >= 0 and spans[s.parent].name == "model.forward"
              and spans[spans[s.parent].parent].name == "engine.prefill"]
    eager_hits = [s.attrs["experts_hit"] for s in layers
                  if "experts_hit" in s.attrs]
    assert len(replays) == 3
    for r in replays:
        assert len(r.attrs["experts_hit"]) == cfg.model.moe_layers
        assert sum(map(sum, r.attrs["experts_hit"])) == \
            8 * cfg.model.num_experts_per_tok * cfg.model.moe_layers
    assert eager_hits and all(sum(h) == 8 * 2 for h in eager_hits)


def test_head_pruning_ranks_query_heads():
    """Under the latent cache each query head keeps its own importance row
    and the head mask keeps ``head_keep`` query heads of each layer (the
    group of a latent row is every head, so ranking kv groups would keep
    them all)."""
    c = tiny_config(plain=False)
    cfg, params, _ = program_and_reference(c, 8)
    state = init_state(cfg, batch=2, device="cpu")
    assert state.importance.shape[2] == cfg.model.num_heads
    assert state.cache.k.full.shape[-1] == 40 and state.cache.k.heads == 1
    ids = torch.from_numpy(np.random.default_rng(4).integers(
        0, 256, (2, 20)).astype(np.int64))
    res = gen.generate(params, cfg, ids, 12, device="cpu")
    assert res.head_mask_updates
    kept = res.state.head_mask.sum(-1)
    assert kept.tolist() == [3] * cfg.model.num_layers
    with pytest.raises(NotImplementedError, match="latent"):
        transformer.compact_head_params(params, cfg, res.state.head_mask)


def test_init_params_lays_out_the_paths_tree():
    """The port's ``init_params`` for a DeepSeek-V2 configuration and the
    benchmark path's ``make_params`` give the same tree: the same leaves,
    each of the same shape."""
    c = tiny_config(plain=False)
    path = manifest.path(c)
    m = path.program_config(c).model
    p = transformer.init_params(m, 0, dtype=torch.float32, device="cpu")
    q = path.make_params(c, 0, "cpu", torch.float32)
    assert jsonable_shapes(p) == jsonable_shapes(q)


def jsonable_shapes(tree):
    if isinstance(tree, torch.Tensor):
        return list(tree.shape)
    return {k: jsonable_shapes(v) for k, v in tree.items()}


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_through_the_harness(tmp_path, trace):
    """A tiny DeepSeek-V2 chat cell through the benchmark's harness on
    the CPU (``portbench/tests/tiny.py``'s root, the real readers and
    paths): the server serves it, the reference judges it ``correct``,
    and a traced run reads ``moe.host_us`` and ``step.active_mfu`` (the
    rooflines need the card's trace)."""
    import json
    import time
    root, bdir, bench = tiny.make_root(tmp_path)
    c = tiny_config(plain=False)
    c["engine"].update(max_batch_size=4, cache_capacity=128,
                       decode_window=8)
    c["spatten"].update(important_size=60, recent_size=25)
    (bdir / "configs" / "tinyv2.json").write_text(json.dumps(c))
    bench["configs"].append({"name": "tinyv2", "source": "test",
                             "file": "portbench/configs/tinyv2.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tinyv2.chat", "config": "tinyv2",
                               "traffic": "chat", "chips": 1, "why": "test"})
    (bdir / "limits" / "tinyv2.chat.json").write_text(json.dumps(
        {"first_gap_max": 2.0, "gap_mean": 0.3, "head_mask_mismatch": 0,
         "tokens_judged": 8}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    r = harness.run("tinyv2.chat", 2 ** 31 + 5, 3.0, trace,
                    t_start=time.perf_counter(), device="cpu", root=root,
                    bench=bench, bench_dir=bdir)
    assert r["correct"], r["compared"]
    got = r["metrics"]
    if trace:
        assert got["moe.host_us"]["value"] > 0
        assert got["step.active_mfu"]["value"] > 0
        assert "moe.roofline" not in got and "mla.k1_roofline" not in got
    else:
        assert got["out_tok_s"]["value"] > 0


@pytest.mark.parametrize("live", [12, None])
def test_latent_k1_bytes_take_the_paths_arguments(live):
    """The path's ``k1_bytes`` takes ``counts.k1_bytes``'s arguments (the
    cache's one row of 576 lanes, 512 latent, read by 16 query heads) and
    counts one row of 100 live tokens at capacity 2048 by hand: the
    appended row 576 + 288 + 2; the 4-bit rows 100 x 576, their scales
    100 x 2, the live heads' importance read and written 2 x heads x 100 x
    2, 64 kept V rows at 512 lanes + 2; the queries, outputs and new row
    in f32, 4 x (16 x 576 + 16 x 512 + 576), and 5 bytes of stats."""
    import inspect

    from portbench import counts, counts_deepseek_v2
    contract = inspect.signature(counts.k1_bytes).parameters
    ours = inspect.signature(counts_deepseek_v2.k1_bytes).parameters
    assert list(ours)[:len(contract)] == list(contract)
    heads = 16 if live is None else live
    want = (576 + 288 + 2 + 100 * 576 + 100 * 2 + 2 * heads * 100 * 2
            + 64 * (512 + 2) + 4 * (16 * 576 + 16 * 512 + 576) + 5)
    got = counts_deepseek_v2.k1_bytes(
        [100], [[True]], [[False]], [[64]], kv_heads=1, group=16,
        head_dim=576, capacity=2048, rung=2048, scale_bytes=2, imp_bytes=2,
        live_heads=None if live is None else [[live]])
    assert got == want
