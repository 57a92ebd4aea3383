"""K1's shared-memory plan on the CPU: ``ops/fused_decode.smem_bytes``
(the mirror of ``smem_bytes`` in ``csrc/fused_decode.cu``, whose tile
ring, score plane and scratch it counts) stays under the card's 227 KB
per block at every (GQA group, head_dim, rung, v_block) the port
launches, and ``check_smem`` refuses a shape past it.  The shapes come
from the configurations ``chip_smoke.py`` drives and from the card tests
(``tests/test_torch_cuda.py``)."""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from spatten_tpu_torch.ops import fused_decode as fd

torch.set_num_threads(1)

CU = Path(fd.__file__).resolve().parent.parent / "csrc" / "fused_decode.cu"


def _cfg_shape(cfg, rung):
    m, vb = cfg.model, cfg.pruning.v_block_size
    return (fd.instance_group(m.q_heads_per_kv), fd.instance_dim(m.head_dim), rung, vb)


# name -> (group, head_dim, rung, v_block)
LAUNCHES = {
    "serving rung 2048": _cfg_shape(chip_smoke.serving_config(2), 2048),
    "serving rung 4096": _cfg_shape(chip_smoke.serving_config(2), 4096),
    "first slice 1024": _cfg_shape(chip_smoke.slice_config(2), 1024),
    "parity 1024": _cfg_shape(chip_smoke.parity_config(2), 1024),
    # chip_smoke.phase_split_k: 4 shards of SPLIT_CL tokens, v_block 64,
    # 32 query heads over 32 (MHA) or 8 (GQA) kv heads of 128
    "split-K shard MHA": (1, 128, chip_smoke.SPLIT_CL, 64),
    "split-K shard GQA": (4, 128, chip_smoke.SPLIT_CL, 64),
    "split-K unsharded MHA": (1, 128, chip_smoke.SPLIT_N
                              * chip_smoke.SPLIT_CL, 64),
    "split-K unsharded GQA": (4, 128, chip_smoke.SPLIT_N
                              * chip_smoke.SPLIT_CL, 64),
    # test_k1_matches_plain's instances (capacity 256, v_block 16)
    "card test <1, 128>": (1, 128, 256, 16),
    "card test <2, 64>": (2, 64, 256, 16),
    "card test <4, 128>": (4, 128, 256, 16),
    "card test <8, 64>": (8, 64, 256, 16),
    "card test GQA 4 over 2048": (4, 128, 2048, 16),
    # head_dim 100 in <1, 128>; Llama-3.2-3B's group 3 in <4, 128>
    "OpenLLaMA-3B 2048": _cfg_shape(chip_smoke.openllama_3b_config(2), 2048),
    "Llama-3.2-3B rung 2048": _cfg_shape(chip_smoke.llama32_3b_config(2),
                                         2048),
    "Llama-3.2-3B rung 4096": _cfg_shape(chip_smoke.llama32_3b_config(2),
                                         4096),
    # chip_smoke.phase_k1_head_dims / phase_k1_capacity (shared plane)
    **{f"phase_k1_head_dims {name}": (
        fd.instance_group(hq // hkv), fd.instance_dim(d), cap, 64)
       for name, (hq, hkv, d, cap, _, _) in chip_smoke.HEAD_DIM_CASES.items()
       if cap < 16384},
    **{f"phase_k1_capacity {name}": (1, 128, rung, vb)
       for name, (_, rung, vb, *_) in chip_smoke.CAPACITY_CASES.items()},
}


@pytest.mark.parametrize("name", list(LAUNCHES))
def test_k1_smem_fits(name):
    group, d, rung, vb = LAUNCHES[name]
    smem = fd.check_smem(group, d, rung, vb)
    assert smem == fd.smem_bytes(group, d, rung, vb)
    assert 0 < smem <= 227 * 1024
    # the ring and its barriers come on top of the score plane
    assert smem > fd._STAGES * fd._STAGE_STRIDE + 4 * group * rung
    assert fd.scores_in_smem(group, d, rung, vb)


def test_k1_serving_fits_two_ctas_per_sm():
    """The main path's <1, 128> CTAs at either rung leave room for two per
    SM (228 KB of shared memory per SM, 1 KB reserved per block)."""
    for rung in (2048, 4096):
        assert 2 * (fd.smem_bytes(1, 128, rung, 64) + 1024) <= 228 * 1024


def test_k1_smem_refuses_past_the_limit():
    with pytest.raises(NotImplementedError, match="shared memory"):
        fd.check_smem(8, 128, 8192, 64)
    with pytest.raises(NotImplementedError):
        fd.check_smem(4, 128, 16384, 64)


def test_k1_smem_mirror_matches_the_kernel_source():
    """The Python constants are the .cu's (each file names the other)."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") == fd._THREADS
    assert const("kStages") == fd._STAGES
    assert const("kStageBytes") + const("kSegBytes") == fd._STAGE_STRIDE
    assert const("kMisc") == fd._MISC_PER_ROW
    assert "ops/fused_decode.py" in src and "smem_bytes" in src
