"""K1's latent instance on the CPU: where the wrapper sends a call.

``ops/fused_decode.k1_plan`` picks the latent instance (one CTA a batch
row, all 16 query rows, tensor-core products; ``csrc/
fused_decode_latent.cu``) exactly for one cached head read by a group of
9-16 query rows of 257-640 lanes under the latent serving flags
(``latent_takes``), and leaves every shape of the other plan tests and of
``chip_smoke.py``'s K1 phases on its ``<G, D>`` instance, whatever the
flags.  Its shared-memory plan (``latent_smem_bytes``, the mirror of
``lat_smem_bytes``) fits 227 KB at the cell's rung 2048 with the score
plane on chip and at 4096 with it in device memory.  The wrapper's card
branch (``is_cuda`` patched, the launch recorded) hands the C entry G =
16, counts ``latent_launches`` and notes the instance on its
``k1.launch`` span; a CPU call runs the plain version and counts nothing.
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from spatten_tpu_torch.kernel_checks import random_state
from spatten_tpu_torch.ops import fused_decode as fd
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)

CSRC = Path(fd.__file__).resolve().parent.parent / "csrc"

# the cell's flags for a latent cache, as run_layers passes them
CELL = dict(quant_enabled=True, has_lsb2=False, quantize_queries=True,
            pv_int8=True, importance_kind="prob", delta_rows=True)


def takes(kv_heads, cap, **change):
    return fd.latent_takes(kv_heads, cap, **dict(CELL, **change))


# (group, head_dim, capacity, rung, v_block, 2-bit plane, in shared memory)
LATENT_SHAPES = {
    "cell rung 2048": (16, 576, 2048, 2048, 64, False, True),
    "capacity 4096 rung 4096": (16, 576, 4096, 4096, 64, False, False),
    "capacity 4096 rung 2048": (16, 576, 4096, 2048, 64, False, True),
    "6-bit profile": (16, 576, 2048, 2048, 64, True, True),
    "12 of 16 rows": (12, 576, 2048, 2048, 64, False, True),
    "9 rows of 288": (9, 288, 2048, 2048, 32, False, True),
    "640 lanes, v_block 128": (16, 640, 4096, 4096, 128, False, False),
}


@pytest.mark.parametrize("name", list(LATENT_SHAPES))
def test_latent_plan_at_latent_shapes(name):
    group, d, cap, rung, vb, lsb2, in_smem = LATENT_SHAPES[name]
    assert takes(1, cap, has_lsb2=lsb2)
    plan = fd.k1_plan(group, d, rung, vb, latent=True)
    assert plan.latent and (plan.inst, plan.dim, plan.rows) == (16, 640, 16)
    assert plan.scores_in_smem is in_smem and plan.blocks_in_smem
    assert plan.smem == fd.latent_smem_bytes(rung, vb, in_smem)
    assert plan.smem <= 227 * 1024
    # without the flags the call keeps the instance it ran before
    old = fd.k1_plan(group, d, rung, vb)
    assert not old.latent and old.inst == 8 and old.dim == 256


def _smoke_shapes():
    """(hq, hkv, head_dim, capacity, rung, v_block) of chip_smoke.py's K1
    phases (but the latent ones) and of the shared-memory plan tests."""
    from tests.test_torch_k1_smem import LAUNCHES
    out = {f"smem test {k}": (g, 1, d, rung, rung, vb)
           for k, (g, d, rung, vb) in LAUNCHES.items()}
    for k, (hq, hkv, d, _, rungs) in chip_smoke.WIDE_GROUP_CASES.items():
        for rung in rungs:
            out[f"{k} rung {rung}"] = (hq, hkv, d, 4096, rung, 64)
    for k, (hq, hkv, cap, vb, _) in chip_smoke.LONG_WINDOW_CASES.items():
        out[k] = (hq, hkv, 128, cap, cap, vb)
    for k, (hq, hkv, d, cap, rung, _) in chip_smoke.GROUP_CASES.items():
        out[k] = (hq, hkv, d, cap, rung, 64)
    for k, (hq, hkv, d, cap, *_) in chip_smoke.HEAD_DIM_CASES.items():
        out[k] = (hq, hkv, d, cap, cap, 64)
    for k, (hq, hkv, d, _) in chip_smoke.WIDE_HEAD_DIM_CASES.items():
        out[k] = (hq, hkv, d, 4096, 4096, 64)
    for k, (hq, hkv, _) in chip_smoke.SHARD_SHAPE_CASES.items():
        out[k] = (hq, hkv, 128, 4096, 4096, 64)
    for k, cfg in (("serving", chip_smoke.serving_config(2)),
                   ("Llama-3.2-3B", chip_smoke.llama32_3b_config(2)),
                   ("OpenLLaMA-3B", chip_smoke.openllama_3b_config(2)),
                   ("deepseek7b.chat", _deepseek7b())):
        m = cfg.model
        out[k] = (m.num_heads, m.num_kv_heads, m.head_dim,
                  cfg.engine.cache_capacity, cfg.engine.cache_capacity,
                  cfg.pruning.v_block_size)
    return out


def _deepseek7b():
    import json
    from portbench import manifest
    c = json.loads((Path(chip_smoke.__file__).resolve().parent / "portbench"
                    / "configs" / "deepseek-llm-7b-chat.json").read_text())
    c["num_hidden_layers"] = 2
    return manifest.path(c).program_config(c)


SMOKE_SHAPES = _smoke_shapes()


@pytest.mark.parametrize("name", list(SMOKE_SHAPES))
def test_other_shapes_keep_their_instance(name):
    """Even under the latent flags (the most the plan is offered), every
    other shape plans as before: no latent plan, the same <G, D> plan."""
    hq, hkv, d, cap, rung, vb = SMOKE_SHAPES[name]
    group = hq // hkv
    latent = fd.latent_takes(hkv, cap, **CELL)
    plan = fd.k1_plan(group, d, rung, vb, latent=latent)
    assert not plan.latent
    assert plan == fd.k1_plan(group, d, rung, vb)


@pytest.mark.parametrize("change", [
    dict(kv_heads=2), dict(quant_enabled=False), dict(quantize_queries=False),
    dict(pv_int8=False), dict(importance_kind="presoftmax"),
    dict(delta_rows=False), dict(append_mask=torch.ones(2, dtype=torch.bool)),
    dict(return_row_stats=True), dict(skip_append=True),
    dict(cap=3000), dict(cap=1020, has_lsb2=True)])
def test_latent_flags_refuse_what_the_instance_does_not_take(change):
    change = dict(change)
    kv_heads, cap = change.pop("kv_heads", 1), change.pop("cap", 2048)
    assert takes(1, 2048)
    assert not takes(kv_heads, cap, **change)


@pytest.mark.parametrize("group,d,vb", [(8, 576, 64), (17, 576, 64),
                                        (16, 256, 64), (16, 656, 64),
                                        (16, 584, 64), (16, 576, 16),
                                        (16, 576, 96)])
def test_latent_shape_bounds(group, d, vb):
    """Groups of 9-16, rows of 257-640 lanes in whole 16-byte columns, and
    v_block 32 or a multiple of 64; anything else keeps its instance."""
    assert not fd.k1_plan(group, d, 2048, vb, latent=True).latent


def test_latent_plan_past_the_limit():
    """Past 2,176 tokens the score plane moves to device memory; past
    1,707 V blocks the per-V-block arrays would pass 227 KB too, and the
    call keeps <8, 256>."""
    assert fd.k1_plan(16, 576, 2176, 64, latent=True).scores_in_smem
    assert not fd.k1_plan(16, 576, 2240, 64, latent=True).scores_in_smem
    assert fd.k1_plan(16, 576, 1707 * 64, 64, latent=True).latent
    far = fd.k1_plan(16, 576, 1708 * 64, 64, latent=True)
    assert not far.latent and far == fd.k1_plan(16, 576, 1708 * 64, 64)


def test_latent_smem_mirror_matches_the_kernel_source():
    src = (CSRC / "fused_decode_latent.cu").read_text()
    old = (CSRC / "fused_decode.cu").read_text()

    def const(name, text=src):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("kLatRows") == fd._LATENT_ROWS
    assert const("kLatBoxes") * 128 == fd._LATENT_LANES
    assert const("kLatTile") == fd._LATENT_TILE
    assert const("kLatStages") == fd._LATENT_STAGES
    assert (const("kLatBoxes") * const("kLatTile") * 128
            + const("kLatSegBytes")) == fd._LATENT_STAGE_STRIDE
    assert const("kLatPad") == fd._LATENT_PAD
    assert const("kLatAlign") == fd._LATENT_ALIGN
    assert const("kMisc", old) == fd._MISC_PER_ROW
    assert "latent_smem_bytes" in src and "lat_smem_bytes" in src
    # the C entry sends G = 16 to the latent unit
    assert "if (G == 16)" in old and "spatten_fused_decode_latent" in old


def _latent_call(monkeypatch, cap, *, card, **extra):
    """One K1 call on a 1-layer latent cache (batch 2, 16 heads over one
    row of 576 lanes) with the cell's flags; ``card``: down the wrapper's
    card branch (``is_cuda`` patched, the launch recorded).  Returns
    (the recorded launch arguments or None, the k1.launch spans)."""
    cfg = chip_smoke.latent_config(1, 2)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, cache_capacity=cap))
    m = cfg.model
    g = torch.Generator().manual_seed(3)
    st = random_state(cfg, 2, g, "cpu")
    q = torch.randn((2, m.num_heads, 1, m.cache_dim), generator=g)
    row = torch.randn((2, 1, 1, m.cache_dim), generator=g)
    hm = torch.ones(m.num_heads, dtype=torch.bool)
    hm[[1, 6, 11, 12]] = False
    launched = []
    if card:
        monkeypatch.setattr(fd.kernels, "launch",
                            lambda name, *args: launched.append(args))
        monkeypatch.setattr(fd.kernels, "ptr", lambda t: t)
    tracer.drain()
    tracer.enable()
    try:
        with monkeypatch.context() as mp:
            if card:
                mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
            fd.fused_decode_attention(
                q, st.cache.k, st.cache.v, row, row,
                torch.tensor([cap, 37], dtype=torch.int32), layer=0,
                **dict(chip_smoke.k1_flags(cfg, 0, cap),
                       sm_scale=m.softmax_scale, requant_threshold=0.05,
                       v_block_size=cfg.pruning.v_block_size, head_mask=hm,
                       per_row_importance=True, importance_in=None),
                **extra)
    finally:
        tracer.disable()
    spans = [s for s in tracer.drain() if s.name == "k1.launch"]
    return (launched[0] if launched else None), spans


@pytest.fixture
def counts():
    """K1's launch counters, put back after the test."""
    f = fd.fused_decode_attention
    before = f.launches, f.latent_launches
    yield f
    f.launches, f.latent_launches = before


@pytest.mark.parametrize("cap,plane", [(2048, None), (4096, (2, 1, 16, 4100))])
def test_card_branch_launches_the_latent_instance(monkeypatch, counts, cap,
                                                  plane):
    n, lat = counts.launches, counts.latent_launches
    args, spans = _latent_call(monkeypatch, cap, card=True)
    b, hq, hkv, inst, dim, d = args[23:29]
    assert (b, hq, hkv, inst, dim, d) == (2, 16, 1, 16, 640, 576)
    assert (None if args[22] is None else tuple(args[22].shape)) == plane
    assert args[-1] is None                       # no block plane
    assert (counts.launches, counts.latent_launches) == (n + 1, lat + 1)
    assert [s.attrs["instance"] for s in spans] == ["latent"]


def test_card_branch_row_stats_keep_the_old_instance(monkeypatch, counts):
    lat = counts.latent_launches
    args, spans = _latent_call(monkeypatch, 2048, card=True,
                               return_row_stats=True)
    assert args[26:28] == (8, 256)
    assert counts.latent_launches == lat
    assert [s.attrs["instance"] for s in spans] == ["<8, 256>"]


def test_cpu_call_takes_the_plain_version(monkeypatch, counts):
    """On CPU tensors the wrapper runs the plain version: no launch, no
    latent launch, no k1.launch span."""
    n, lat = counts.launches, counts.latent_launches
    args, spans = _latent_call(monkeypatch, 2048, card=False)
    assert args is None and spans == []
    assert (counts.launches, counts.latent_launches) == (n, lat)
    assert counts.latent_launches == 0


def test_pack_unit_of_the_cell():
    """The cell's capacity 2048 is one pack unit: its halves (and
    quarters) hold whole tiles of packed rows."""
    assert qz.pack_unit(2048) == qz.pack_unit(4096) == 2048
