"""The decode gate on the CPU: which single-token steps go through K1.

``transformer.decode_uses_kernel(cfg, device_type)`` decides from the
configuration alone by the JAX gate's terms (``spatten_tpu/models/
transformer.py``: ``(hkv*dh) % 128 == 0 or on_cpu``): on the CPU, K1's
plain version takes every shape; on the card, a fused lane width that is
not a multiple of 128 takes the reference path.  Every other shape goes
to K1, whose wrapper raises where the kernel does not take it
(``fused_decode.k1_shape_error``).  The shapes: ``ModelConfig.tiny()``
(lane width 16: off K1), Llama-2-70B's GQA group at capacity 4096 and a
GQA-4 model at capacity 16384 (on K1, with the score plane in device
memory, as their [G, C] planes overflow shared memory), the serving,
parity and Llama-3.2-3B configurations of ``chip_smoke.py`` and its
GQA-3 gate model (on K1, plane in shared memory).  A GQA group of 3, 5,
6 or 7 runs in the kernel's <4, D> or <8, D> instance, whose
shared-memory plan decides where the score plane lies; a head_dim runs in
the smallest instance dim that holds it, and one past 256 (300) in 256 as
lane pieces.  The tiny model then runs
the path the card's gate picks for it (``use_pallas=False``) against the
JAX package's jnp path: greedy tokens, layer lengths and requant events
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.models import transformer as jtr
from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer as tr
from spatten_tpu_torch.ops import fused_decode as fd
from spatten_tpu_torch.pruning.token_pruning import layer_capacity_groups

torch.set_num_threads(1)

[TINY] = list(chip_smoke.gate_configs())
[GQA8] = list(chip_smoke.device_scores_configs())
GQA3 = chip_smoke.GQA3_NAME


def gqa4_16k():
    """G = 4 (8 query heads over 2 kv heads of 128) at capacity 16384."""
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig(vocab_size=256, hidden_size=256, num_layers=2,
                               num_heads=8, num_kv_heads=2, head_dim=128,
                               intermediate_size=512),
        pruning=tcfg.PruningConfig(v_block_size=64),
        engine=tcfg.EngineConfig(max_batch_size=1, cache_capacity=16384),
    ).validate()


# name -> (configuration, whether the card's gate sends decode to K1,
# whether K1's score plane then lies in device memory)
SHAPES = {
    "tiny": (lambda: chip_smoke.gate_configs()[TINY][0], False, False),
    "GQA 8 x 128, cap 4096": (
        lambda: chip_smoke.device_scores_configs()[GQA8][0], True, True),
    "GQA 4 x 128, cap 16384": (gqa4_16k, True, True),
    "serving, rungs 2048/4096": (chip_smoke.serving_config, True, False),
    "parity": (chip_smoke.parity_config, True, False),
    "GQA 3 x 64, cap 64": (
        lambda: chip_smoke.group_configs()[GQA3][0], True, False),
    "GQA 16 x 128, cap 64": (
        lambda: chip_smoke.group_configs()[chip_smoke.GQA16_NAME][0], True,
        True),
    "Llama-3.2-3B (GQA 3 x 128), rungs 2048/4096": (
        chip_smoke.llama32_3b_config, True, False),
}


def gate_rungs(cfg):
    cap = cfg.engine.cache_capacity
    return sorted({cap} | {r for _, _, r in layer_capacity_groups(cfg)})


@pytest.mark.parametrize("name", list(SHAPES))
def test_gate_decision(name):
    make, on_card, _ = SHAPES[name]
    cfg = make()
    assert tr.decode_uses_kernel(cfg, "cuda") is on_card
    assert tr.decode_uses_kernel(cfg, "cpu") is True
    off = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, use_pallas=False))
    assert not tr.decode_uses_kernel(off, "cuda")
    assert not tr.decode_uses_kernel(off, "cpu")


@pytest.mark.parametrize("hkv,dh,on_card", [
    (2, 8, False), (16, 8, True), (1, 64, False), (2, 64, True),
    (1, 128, True), (3, 96, False)])
def test_gate_is_the_jax_lane_term(hkv, dh, on_card):
    """On the card the gate refuses exactly the fused lane widths Hkv * D
    that are not multiples of 128, as the JAX gate does; on the CPU it
    refuses none."""
    m = tcfg.ModelConfig(vocab_size=64, hidden_size=2 * hkv * dh,
                         num_layers=1, num_heads=2 * hkv, num_kv_heads=hkv,
                         head_dim=dh, intermediate_size=64)
    cfg = tcfg.SpAttenConfig(
        model=m, pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                            recent_size=16, v_block_size=8),
        engine=tcfg.EngineConfig(cache_capacity=64, prefill_chunk=8)
    ).validate()
    assert tr.decode_uses_kernel(cfg, "cuda") is on_card
    assert tr.decode_uses_kernel(cfg, "cpu") is True


def test_gate_matches_the_wrappers_limits(monkeypatch):
    """On every shape, the gate's answer and the wrapper's raise agree: the
    wrapper is run down its card branch on CPU tensors (``is_cuda``
    patched, the launch replaced by a recorder) at the stored capacity and
    at each rung.  A shape the gate sends to K1 reaches the launch, with a
    score plane in device memory exactly where shared memory cannot hold
    it.  K1 takes every head_dim up to 256 and every even capacity, so
    the wrapper refuses none of these shapes: the tiny model, which the
    gate sends elsewhere, would launch <2, 64> with 8 live lanes."""
    launched = []
    monkeypatch.setattr(fd.kernels, "launch",
                        lambda name, *args: launched.append((name, args)))
    count = fd.fused_decode_attention.launches
    g = torch.Generator().manual_seed(0)
    from spatten_tpu_torch.kernel_checks import random_state
    for name, (make, on_card, device_scores) in SHAPES.items():
        cfg = make()
        one = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, num_layers=1))
        m, cap, vb = cfg.model, cfg.engine.cache_capacity, \
            cfg.pruning.v_block_size
        st = random_state(one, 1, g, "cpu")
        q = torch.randn((1, m.num_heads, 1, m.head_dim), generator=g)
        kv = torch.randn((1, m.num_kv_heads, 1, m.head_dim), generator=g)
        refused = []
        for rung in gate_rungs(cfg):
            before = len(launched)
            with monkeypatch.context() as mp:
                mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
                try:
                    fd.fused_decode_attention(
                        q, st.cache.k, st.cache.v, kv, kv,
                        torch.tensor([rung // 2], dtype=torch.int32),
                        layer=0, v_block_size=vb,
                        importance_in=st.importance,
                        quant_enabled=cfg.quant.enabled,
                        cap_override=rung if rung < cap else None)
                except NotImplementedError as e:
                    err = fd.k1_shape_error(m.q_heads_per_kv, m.head_dim,
                                            cap, rung, vb)
                    assert str(e) == err
                    refused.append(rung)
                    continue
            [(kernel, args)] = launched[before:]
            assert kernel == "fused_decode", (name, rung)
            # the score plane's pointer (null: in shared memory), by the
            # plan of the instance that runs the group and head_dim (a
            # group past 8 keeps it in device memory)
            in_smem = fd.k1_plan(m.q_heads_per_kv, m.head_dim, rung,
                                 vb).scores_in_smem
            assert (args[22] is None) is in_smem, (name, rung)
            if rung == cap:
                assert in_smem is not device_scores, name
        assert not refused, (name, refused)
    fd.fused_decode_attention.launches = count


def test_gate_limits_are_the_smem_plans():
    """``smem_bytes`` at v_block 64: GQA 8 at 4096 tokens and GQA 4 at
    16384 pass 227 KB with the score plane in shared memory and fit with
    it in device memory, so K1 takes them; the main path's instance keeps
    it in shared memory at both serving rungs.  A plan that overflows
    even without the plane keeps its per-V-block arrays in device memory
    too, and K1 takes it; head dims and capacities it runs (head_dim 8 in
    64, 100 in 128, 300 in 256 as two lane pieces; 1020 tokens at v_block
    4) pass."""
    assert fd.smem_bytes(8, 128, 4096, 64) == 241_804
    assert fd.smem_bytes(4, 128, 16384, 64) == 359_884
    assert fd.smem_bytes(8, 128, 4096, 64, in_smem=False) == 110_732
    assert fd.smem_bytes(4, 128, 16384, 64, in_smem=False) == 97_740
    for group, cap in ((8, 4096), (4, 16384)):
        assert not fd.scores_in_smem(group, 128, cap, 64)
        assert fd.k1_shape_error(group, 128, cap, cap, 64) is None
    for rung in (2048, 4096):
        assert fd.scores_in_smem(1, 128, 4096, 64)
        assert fd.k1_shape_error(1, 128, 4096, rung, 64) is None
    assert fd.k1_shape_error(8, 128, 262144, 262144, 64) is None
    plan = fd.k1_plan(8, 128, 262144, 64)
    assert not plan.scores_in_smem and not plan.blocks_in_smem
    assert fd.smem_bytes(8, 128, 262144, 64, in_smem=False) > 227 * 1024
    assert plan.smem == fd.smem_bytes(8, 128, 262144, 64, in_smem=False,
                                      blocks_in_smem=False) <= 227 * 1024
    assert fd.k1_shape_error(2, 300, 64, 64, 8) is None   # lane pieces
    assert fd.k1_shape_error(2, 8, 64, 64, 8) is None
    assert fd.k1_shape_error(1, 100, 2048, 2048, 64) is None
    assert fd.k1_shape_error(1, 128, 1020, 1020, 4) is None


def one_layer(hq, hkv, d, cap, vb):
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig(vocab_size=64, hidden_size=hq * d,
                               num_layers=1, num_heads=hq, num_kv_heads=hkv,
                               head_dim=d, intermediate_size=64),
        pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                   recent_size=16, v_block_size=vb),
        engine=tcfg.EngineConfig(cache_capacity=cap, prefill_chunk=8)
    ).validate()


def card_branch(monkeypatch, cfg, seed, **kw):
    """One K1 call down the wrapper's card branch on CPU tensors
    (``is_cuda`` patched); returns the recorded launches."""
    from spatten_tpu_torch.kernel_checks import random_state
    launched = []
    monkeypatch.setattr(fd.kernels, "launch",
                        lambda name, *args: launched.append((name, args)))
    count = fd.fused_decode_attention.launches
    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    st = random_state(cfg, 1, g, "cpu")
    q = torch.randn((1, m.num_heads, 1, m.head_dim), generator=g)
    kv = torch.randn((1, m.num_kv_heads, 1, m.head_dim), generator=g)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
            fd.fused_decode_attention(
                q, st.cache.k, st.cache.v, kv, kv,
                torch.tensor([20], dtype=torch.int32), layer=0,
                v_block_size=cfg.pruning.v_block_size,
                importance_in=st.importance, **kw)
    finally:
        fd.fused_decode_attention.launches = count
    return launched


# group -> (query heads, kv heads, head_dim, capacity): shapes where the
# model group's own plan would keep the score plane in shared memory and
# the instance's (4 or 8 rows) does not
GROUP_SHAPES = {3: (6, 2, 128, 9216), 5: (10, 2, 128, 4096),
                6: (6, 1, 128, 4096), 7: (14, 2, 128, 4096)}


@pytest.mark.parametrize("group", list(GROUP_SHAPES))
def test_group_runs_in_a_larger_instance(monkeypatch, group):
    """A GQA group of 3, 5, 6 or 7 (the gate admits every lane width here)
    reaches the launch down the card branch: the instance group (4 for 3,
    8 for the rest) and the live group (the model's) are passed to the
    kernel, and the score plane lies where the instance's shared-memory
    plan puts it -- in device memory at these shapes, where a plan of the
    model's group would still fit 227 KB."""
    hq, hkv, d, cap = GROUP_SHAPES[group]
    cfg = one_layer(hq, hkv, d, cap, 64)
    assert tr.decode_uses_kernel(cfg, "cuda")
    inst = fd.instance_group(group)
    assert inst == (4 if group == 3 else 8)
    assert fd.k1_shape_error(group, d, cap, cap, 64) is None
    assert not fd.scores_in_smem(inst, d, cap, 64)
    # the plan without the padding rows: each row of G takes 4 * (C + 8 D
    # + C / v_block + 8) + C / v_block bytes
    own_plan = fd.smem_bytes(inst, d, cap, 64) - 4 * (inst - group) * (
        cap + 8 * d + cap // 64 + 8) - (inst - group) * (cap // 64)
    assert own_plan <= 227 * 1024
    [(kernel, args)] = card_branch(monkeypatch, cfg, group)
    assert kernel == "fused_decode"
    b, hq_arg, hkv_arg, inst_arg, dim_arg, d_arg = args[23:29]
    assert (b, hq_arg, hkv_arg, dim_arg, d_arg) == (1, hq, hkv, d, d)
    assert hq_arg // hkv_arg == group and inst_arg == inst
    assert args[22] is not None          # the device-memory score plane
    # at a small window the instance's plan keeps it in shared memory
    small = one_layer(hq, hkv, d, 256, 16)
    [(_, args)] = card_branch(monkeypatch, small, group)
    assert args[26] == inst and args[22] is None
    assert fd.scores_in_smem(inst, d, 256, 16)


def test_group_past_the_instances_raises():
    """Groups above 8 run in the group-8 instance, in chunks of 8 rows of
    a score plane in device memory, so K1 takes them; what still raises:
    a group below 1, a plan for a group that is not an instance group,
    and a shared-memory score plan of more rows than the instance's."""
    for group, rows in ((9, 16), (12, 16), (16, 16), (17, 24), (32, 32)):
        assert fd.instance_group(group) == 8
        assert fd.plane_rows(group) == rows
        assert fd.k1_shape_error(group, 128, 64, 64, 8) is None
        plan = fd.k1_plan(group, 128, 64, 8)
        assert plan.rows == rows and not plan.scores_in_smem
    with pytest.raises(ValueError):
        fd.instance_group(0)
    with pytest.raises(ValueError):
        fd.smem_bytes(3, 128, 4096, 64)      # not an instance group
    with pytest.raises(ValueError):
        fd.smem_bytes(8, 128, 64, 8, rows=16)


@pytest.mark.parametrize("head_dim,k2", [(8, False), (16, True)])
def test_compaction_sends_head_dims_k2_does_not_take_to_the_gather(
        monkeypatch, head_dim, k2):
    """On the card the prune compaction moves rows through K2 only where
    ``k2_takes`` (head_dim % 16 == 0), else through the gather, as the JAX
    compaction's gate does; run on CPU tensors with ``is_cuda`` patched
    and the launch recorded."""
    from spatten_tpu_torch.engine.kv_cache import LayerKVCache
    from spatten_tpu_torch.ops import compact_gather as cg
    from spatten_tpu_torch.ops import quantize as qz
    from spatten_tpu_torch.pruning import compact
    launched = []
    monkeypatch.setattr(cg.kernels, "launch",
                        lambda name, *args: launched.append(name))
    count = cg.gather_compact_rows.launches
    g = torch.Generator().manual_seed(1)
    b, h, cap = 1, 2, 64
    cache = LayerKVCache(
        k=qz.quantize(torch.randn((b, h, cap, head_dim), generator=g)),
        v=qz.quantize(torch.randn((b, h, cap, head_dim), generator=g),
                      with_msb=False))
    keep = torch.arange(0, 64, 2, dtype=torch.int32).expand(b, h, 32)
    with monkeypatch.context() as mp:
        mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
        compact.compact_layer(cache, None, keep.contiguous(), rotate_k=False,
                              rope=None)
    assert launched == (["compact_gather"] if k2 else [])
    assert cg.k2_takes(head_dim) is k2
    cg.gather_compact_rows.launches = count


def test_off_kernel_check_replays_generate_on_the_cpu():
    """``kernel_checks.check_against_cpu``, which ``chip_smoke.py`` and the
    card tests run, on the CPU: every forward call of the one ``generate``
    run is replayed from a copy of its state (the prefill chunks and each
    decode step), the replay equals the run exactly, the tokens are
    generate's, K1 stays at 0 and the run prunes; ``transformer.forward``
    is restored after."""
    from spatten_tpu_torch import kernel_checks as kc
    forward = tr.forward
    cfg, batch, plen, new = chip_smoke.gate_configs()[TINY]
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.model.vocab_size,
                                               (batch, plen))
    res = kc.check_against_cpu(cfg, params, prompt, new, torch.device("cpu"))
    assert res["k1"] == 0 and res["prune_points"] > 0
    assert res["calls"] == -(-plen // cfg.engine.prefill_chunk) + new
    assert res["max_logit_err"] == 0.0
    assert tr.forward is forward


def build(mod):
    """The tiny gate configuration, in either package, on the path the
    card's gate picks for it."""
    cfg = chip_smoke.gate_configs()[TINY][0]
    p, q, e = cfg.pruning, cfg.quant, cfg.engine
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=p.start_size,
                                  important_size=p.important_size,
                                  recent_size=p.recent_size,
                                  v_block_size=p.v_block_size),
        quant=mod.QuantConfig(requant_threshold=q.requant_threshold),
        engine=mod.EngineConfig(
            max_batch_size=e.max_batch_size, cache_capacity=e.cache_capacity,
            prefill_chunk=e.prefill_chunk, decode_window=e.decode_window,
            use_pallas=False)).validate()


def test_tiny_off_kernel_path_matches_jax_jnp_path():
    _, batch, plen, new = chip_smoke.gate_configs()[TINY]
    jc, tc = build(jcfg), build(tcfg)
    assert tc.engine == dataclasses.replace(
        chip_smoke.gate_configs()[TINY][0].engine, use_pallas=False)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(
        0, jc.model.vocab_size, (batch, plen)).astype(np.int32)
    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), new)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    tres = tgen.generate(tparams, tc, torch.from_numpy(prompt), new,
                         state=init_state(tc, batch, device="cpu"),
                         device="cpu")
    assert tres.pruned_layers            # the run prunes
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    np.testing.assert_array_equal(
        tres.state.layer_lengths.numpy(),
        np.asarray(jres.state.layer_lengths))
    assert int(tres.requant_events) == int(jres.requant_events)
