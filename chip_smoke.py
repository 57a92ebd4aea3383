#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``spatten_tpu_torch``) on one NVIDIA H100.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and exits non-zero, printing no result, without
one (or without the repository beside it).  ``--cards 4`` runs only the
multi-card slice over NCCL on four cards (``main_cards``, below).
Phases, none of whose failures is caught:

1. the card's name and power limit; build every kernel source in
   ``csrc/`` (one ``nvcc`` per source, in parallel);
2. K1 (fused decode attention) vs its plain PyTorch version on the card:
   at the first slice's shapes (batch 4, capacity 1024), and at the
   serving shapes (one layer of the stacked [32, 8, 4096, 4096] planes,
   ragged lengths, rungs 2048 and 4096) for each serving flag alone, the
   serving combination, the dense combination and 6- and 8-bit layers;
   then K1's remaining flags at the serving shapes (presoftmax importance
   accumulated and in delta mode, prob in delta mode, rows that do not
   append with an empty one, row stats) and per-row importance at a GQA
   shape (32 query heads over 8 kv heads of 128); K1 at Llama-3.2-3B's
   serving shapes (``phase_k1_llama32``: group 3, both rungs, timed);
   the GQA groups 3, 5, 6 and 7 that K1 runs in its <4, D> and <8, D>
   instances (``phase_k1_groups``: head_dim 64 and 128, the score plane
   in shared and in device memory, a partly head-masked group); then K1
   with its score plane in device memory (``phase_k1_device_scores``:
   Llama-2-70B's attention at capacity 4096, Llama-3-8B's at 16384); K1
   at GQA groups past 8, which it runs in <8, 128> as chunks of 8 rows
   (``phase_k1_wide_groups``: Llama-3.1-405B's 128 query heads over 8 kv
   heads at both rungs, and in presoftmax delta mode; group 12 at 6
   bits); K1 with its per-V-block arrays in device memory too
   (``phase_k1_long_windows``: 1 kv head of group 8 at 65,536 tokens, 2
   kv heads at 131,072; f32 and bf16 metadata, every head requantizing
   and none); K1 at head dims past 256 lanes, which it runs in <G, 256>
   as boxes of 256 bytes side by side (``phase_k1_wide_head_dims``: 288,
   384, 512 and 1024 at capacity 4096, batch 4) and at the shard shapes
   of the mesh phases (``phase_k1_shard_shapes``: Llama-2-7B's TP-4 shard
   in <1, 128>, Llama-2-70B's TP-8 shard in <8, 128> on 4 CTAs); K1's
   ``_skip_append`` at the serving shapes (``phase_k1_skip_append``: every
   stage bit-equal to its plain version, no plane byte written, the
   scales and outputs of the appending step, timed with and without the
   append);
   rules and tolerances in ``spatten_tpu_torch/kernel_checks.py``.  K1's times (``time_k1``)
   are device times per call from CUDA events over back-to-back calls
   that walk the stacked layers, so each call finds its planes cold in
   L2 as decode does; the kernel streams them through its shared-memory
   tile ring (``csrc/fused_decode.cu``), whose registers and spills per
   <G, D, score plane in shared memory> instance phase 1 prints
   (no instance may spill);
3. K2 (prune compaction) vs its plain version at both slices' shapes;
4. split-K decode (``phase_split_k``): 4 shards of 2048 tokens on the
   card, MHA and GQA, one K1 launch per shard against one unsharded K1
   call over the same 8192 tokens, before and after ``split_k_prune``
   (which leaves two shards empty); device times printed;
5. the launch probe (``phase_launch_probe``): P1-P5 vs their plain
   versions (exact), then their eager, graph and device times, the
   launch floor (an empty kernel) beside their byte bounds, and the
   yardsticks of ``spatten_tpu_torch/tools/launch_overhead.py``; P2-P5
   against their same-function PyTorch calls as medians of interleaved
   repeats, with the kernels each of those calls launches;
6. a small-model reference check (f32 weights, kernels vs plain versions
   on the card); the decode gate (``phase_gate``): ``generate`` on the
   tiny model, which the gate sends off K1 (``gate_configs()``: K1's
   count stays 0), on a GQA-8 model at capacity 4096, whose K1 score
   plane lies in device memory (``device_scores_configs()``), and on a
   GQA-3 model and a GQA-16 model (``group_configs()``: K1's <4, 64>
   instance with 3 live rows, and <8, 128> in two chunks), K1 launching
   once per layer and step; each call held against its replay on the
   CPU;
   then the paths, each with its launch counts set to 0 just before it
   and read just after:
   a. the first slice: ``generate`` at Llama-2-7B width, depth cut to 8,
      batch 4, prompt 1152, 128 new tokens;
   b. ``serving_config()``: the JAX package's benchmarked SpAtten
      configuration (``bench.py`` ``build_cfg(spatten=True)``) at
      Llama-2-7B width and depth, batch 8, capacity 4096, prompt 3072,
      128 new tokens -- on-the-fly head pruning, capacity rungs, int8
      queries, integer P·V, bf16 probabilities and metadata; then its
      first decode window again through the plain versions, fed the same
      tokens, and a profile of decode;
   c. ``dense_config(8)``: the dense-int8 baseline (``build_cfg(spatten=
      False)``) at depth 8, prefill and 64 decode steps (tok/s printed, no
      claim);
   d. ``profile_config()``: the serving configuration with the 4/4/6/6/8
      quant profile, depth 8, 64 new tokens;
   e. ``parity_config(8)``: the JAX CLI's defaults (``run_spatten_tpu.py``)
      with the reference-parity importance signal (presoftmax, not
      accumulated) at Llama-2-7B width, depth 8, batch 8, prompt 1152,
      128 new tokens; its first decode window again through the plain
      versions (the dense and parity paths run at depth 8 since the
      multi-card phases k.-m. came in);
   f. ``llama32_3b_config()``: Llama-3.2-3B's published widths and depth
      (28 layers, 24 query heads over 8 kv heads of 128, vocab 128256,
      random bf16 weights) under the serving settings, batch 8, capacity
      4096, prompt 3072, 64 new tokens, K1 in <4, 128> with 3 live rows;
      its first decode window again through the plain versions;
   g. the server (``phase_server``) and the workload trace
      (``phase_trace``);
   h. ``phase_supervised``: ``engine.supervisor.generate_supervised`` at
      Llama-2-7B width, depth 8, batch 2, prompt 3072, 64 tokens in
      windows of 16, uninterrupted, with a health probe that fails once
      and resumed from disk in a fresh call: the three token streams
      equal exactly; snapshot bytes and seconds printed; its first
      window against the plain versions;
   i. ``phase_cli``: ``run_spatten_gpu.py`` in a subprocess on a random
      Llama-2-7B-width checkpoint (4 layers) with two turns of token ids:
      replies equal an in-process ``generate`` (its launches counted), a
      trace and a summary; the first window against the plain versions;
   j. ``phase_debug_hook``: ``generate`` under ``SPATTEN_DEBUG=1`` (the
      first prefill chunk under the float checks; launches counted)
      equal to the run without it;
   the accuracy path (``phase_ppl``), ``phase_hbm``, then the bench:
   ``phase_bench``: ``spatten_tpu_torch.tools.bench.run_point`` at its
   third point (Llama-2-7B's TP-8 shard, 8 layers, capacity 4096, batch
   16, int8 weights), 16 steps, one timed window, no extras: K1 launches
   = layers x steps x 2 in each engine's windows, K2's in
   ``measure_prune`` = its layer compactions, a requant rate in (0, 1),
   the spatten engine's first window against the plain versions, the
   point's JSON on a line of its own; ``phase_bench_tools``: one short
   run of each bench tool (``profile_fused``, ``bisect_bench``,
   ``vprune_sweep``, ``prefill_diag``, ``profile_decode`` with its
   profiler trace and its K1 ladder, ``microbench`` bw and floor) at 4096
   x 16, 8 steps a window, each decode tool launching K1;
   the multi-card slice, each rank a process on cuda:0 under gloo (NCCL
   refuses two ranks of one communicator on one card; the collectives go
   through the host, so these times say nothing of NVLink), each rank's
   ``generate`` counted and recorded (``mesh_rank``), its first decode
   window again through the plain versions, K1 = local layers x tokens
   (x microbatches), K2 = the layer compactions of its prune schedule,
   and the run's logits against the same engine's 1-rank run fed the
   same tokens (``against_one_rank``: equal for pipeline stages without
   TP; TP and DP runs, whose last-bit differences SpAtten's discrete
   decisions amplify, within 1.5 times the departure JAX's engine shows
   from its own 1-rank run, measured on the CPU by
   ``tests/test_torch_sharded.py``), and every replicated tensor
   (logits, tokens, lengths, head masks, requant counts) equal bit for
   bit on the ranks that hold it (``utils.debug.replicated_mismatch``);
   before the paths, ``mesh_small_check``: an f32 DP 2 x TP 2 run at
   small width whose tokens equal the same ranks' run on the CPU and
   whose decode steps each match their CPU replay within 1e-3;
   k. ``phase_sharded``: ``ShardedEngine`` on ``serving_config(16)`` at
      Llama-2-7B width, depth 16, mesh data 2 x model 4 (8 ranks, each
      [16, 4, 4096, 1024] planes in K1's <1, 128>), batch 8, prompt 3072,
      32 new tokens;
   l. ``phase_sharded_70b``: Llama-2-70B's widths, depth 8, mesh 1 x 8
      (each rank one kv head of group 8: K1's <8, 128> on 4 CTAs), batch
      4, capacity 4096, prompt 3072, 32 new tokens;
   m. ``phase_pipeline``: ``PipelineEngine`` on Llama-2-7B, 4 stages of 8
      layers, batch 8, M = 1 and M = 2; then 2 stages x TP 2 at depth 16,
      batch 4, M = 2;
   every phase's seconds are printed;
7. a ``kernels`` JSON line: per kernel its launches on the serving path
   (the probes: 0, with their own phase's count beside), error, time on
   the card (``ms``), its plain version's (``plain_ms``), the least time
   the card could take (``bound_ms``, with ``bound_by``) and a PyTorch
   library call's time where one computes the same function; K1's
   4096-rung, parity, split-K, Llama-3.2-3B, group-16, long-window,
   wide-head-dim, shard-shape and mesh numbers and the first slice's
   ride along in extra fields;
8. the card's name and power limit, and as the last line
   ``{"ok": true, "device": {...}}``.

``--cards N`` (four H100s joined by NVLink: ``python3 chip_smoke.py
--cards 4``) prints ``nvidia-smi topo -m``, builds the kernels once, then
runs rank r on cuda:r under NCCL, each rank checked as in phases k.-m.
(its K1/K2 counts, its first window against the plain versions, the
replicated tensors, finite logits), all-reduce and hand-off times from
CUDA events around each collective and K1's time at the rank's shard
shape from the profile: ``ShardedEngine`` at ``serving_config()`` 1 x 4
and 2 x 2 against its 1-rank runs; Llama-2-70B's widths at all 80 layers
over TP 4 (each card draws its shard), and at depth 8 against the 1-rank
run; ``phase_pipeline`` over NCCL; ``run_spatten_gpu.py --mesh_model 4``
under ``torch.distributed.run`` against ``ShardedEngine.generate``; and
split-K over the four cards against unsharded K1.  A failing phase is
printed and the others run on; any failure fails the run.  It ends with
a ``{"cards": ...}`` JSON line, the cards' names and power limits on one
line, and the ``{"ok": true, ...}`` line.

``--phases server`` on one card builds the kernels and runs only the
server's two phases (``server_small_check``, ``phase_server``); each
reports how many prefill chunks replayed from the server's CUDA graph.
``--phases latent`` runs only DeepSeek-V2-Lite's three card checks, which
the full run holds too: ``phase_k1_latent`` (K1's latent instance at the
latent row's shape, at capacity 2048 and both rungs of 4096, against its
plain version, and timed; its 4/6/8-bit and f32-scale paths; a row-stats
call that keeps <8, 256>), ``phase_grouped_gemm`` (the expert layer's
grouped GEMMs against the loop over experts, and from a CUDA graph) and
``phase_server_latent`` (the server on the latent model: K1 once per
layer and decode tick, each launch in the latent instance).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12                   # H100 SXM f32 outside the tensor cores
INT8_OPS = 1979e12                  # H100 SXM int8 (tensor cores, dense)
# Kernels vs plain versions on the card, teacher-forced (the same tokens
# fed to both).  A V-block keep decision whose k-th and (k+1)-th block
# masses nearly tie may resolve differently in the two, and one such flip
# moves the logits of its step and of later layers; so the checks hold
# most steps, not every step.
# Small f32 model: a step agrees when its max |logit diff| <= 1e-3.
SMALL_STEP_TOL = 1e-3
SMALL_STEPS_MIN = 0.9
# bf16 paths: logits are bf16 values (~N(0, 1) at random init; a bf16
# step is 2^-7 to 2^-5 there) and any last-bit difference in an attention
# output reaches the bf16 residual stream, so a window is held by its
# mean error (a few bf16 steps) and its argmax agreement.
WINDOW_MEAN_TOL = 0.05
WINDOW_ARGMAX_MIN = 0.8


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def device_ms(fn, n: int) -> float:
    """Device time of one call of ``fn(i)``, averaged over n calls.

    The calls queue behind a ``torch.cuda._sleep`` so that the events
    bracket back-to-back device work, not the host's launch gaps."""
    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(2e8, 4e9 * host_s)))
    start.record()
    for i in range(n):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# ---------------------------------------------------------------- configs
def slice_config(num_layers: int = 32):
    """The first slice: capacity 1024, f32 metadata, head pruning off."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=dataclasses.replace(ModelConfig.llama2_7b(),
                                  num_layers=num_layers),
        pruning=PruningConfig(start_size=4, important_size=384,
                              recent_size=384),
        quant=QuantConfig(),
        engine=EngineConfig(max_batch_size=4, cache_capacity=1024,
                            prefill_chunk=128),
    ).validate()


SERVING_CAP, SERVING_BATCH, SERVING_PROMPT = 4096, 8, 3072


def serving_config(num_layers: int = 32, layer_bits=None,
                   cap: int = SERVING_CAP):
    """``bench.py`` ``build_cfg(spatten=True, cache=cap, batch=8)`` at
    Llama-2-7B width: the bench's per-chip 3 of 4 kv heads becomes 24 of
    32 (the same 0.75 share)."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=dataclasses.replace(ModelConfig.llama2_7b(),
                                  num_layers=num_layers),
        pruning=PruningConfig(
            start_size=4, important_size=int(cap * 0.55),
            recent_size=int(cap * 0.10),
            cascade_layer_ratios=(1.0, 0.78, 0.25, 0.25, 0.25, 0.14, 0.14,
                                  0.14),
            enable_v_pruning=True, v_keep_ratio=0.25,
            v_block_size=max(64, cap // 64),
            enable_head_pruning=True, head_keep=24, head_update_interval=32,
            importance_dtype="bfloat16"),
        quant=QuantConfig(enabled=True, enable_requant=True,
                          requant_threshold=0.05, quantize_queries=True,
                          layer_bits=layer_bits, pv_int8=True,
                          probs_bf16=True, scale_dtype="bfloat16"),
        engine=EngineConfig(max_batch_size=SERVING_BATCH, cache_capacity=cap,
                            prefill_chunk=128, use_pallas=True,
                            rope_mode="cached"),
    ).validate()


def dense_config(num_layers: int = 32):
    """``bench.py`` ``build_cfg(spatten=False)``: K1 in dense mode with
    int8 queries, integer P·V, bf16 probabilities and scales."""
    from spatten_tpu_torch.config import PruningConfig, QuantConfig
    cfg = serving_config(num_layers)
    return dataclasses.replace(
        cfg,
        pruning=PruningConfig(enable_token_pruning=False,
                              enable_v_pruning=False),
        quant=QuantConfig(enabled=False, enable_requant=False,
                          quantize_queries=True, pv_int8=True,
                          probs_bf16=True, scale_dtype="bfloat16"),
    ).validate()


def profile_config(num_layers: int = 8):
    """The serving configuration with the quant profile 4,4,6,6,8 (padded
    with 8) that ``bench.py`` takes from SPATTEN_BENCH_LAYER_BITS."""
    return serving_config(num_layers, layer_bits=(4, 4, 6, 6, 8))


LLAMA32_NEW_TOKENS = 64


def llama32_3b_config(num_layers: int = 28):
    """``meta-llama/Llama-3.2-3B`` from its published ``config.json``
    (vocab 128256, hidden 3072, 28 layers, 24 query heads over 8 kv heads
    of 128: GQA group 3, lane width 1024; MLP 8192, rope_theta 500000,
    rms_norm_eps 1e-5, tied embeddings) under ``serving_config()``'s
    pruning, quantization and engine settings: batch 8, capacity 4096,
    head pruning keeping 6 of 8 kv heads (the serving share, 0.75).
    Neither package models the config's ``llama3`` RoPE scaling (factor
    32 over 8192 original positions), so positions rotate with plain
    RoPE at theta 500000; the weights are random (real ones are not in
    the repository)."""
    from spatten_tpu_torch.config import ModelConfig
    cfg = serving_config(num_layers)
    model = ModelConfig(
        vocab_size=128256, hidden_size=3072, num_layers=num_layers,
        num_heads=24, num_kv_heads=8, head_dim=128, intermediate_size=8192,
        norm_eps=1e-5, rope_theta=500000.0, max_position_embeddings=131072,
        tie_word_embeddings=True)
    return dataclasses.replace(
        cfg, model=model,
        pruning=dataclasses.replace(cfg.pruning, head_keep=6)).validate()


# openlm-research/open_llama_3b's published config.json
OPENLLAMA_3B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "bos_token_id": 1,
    "eos_token_id": 2, "hidden_act": "silu", "hidden_size": 3200,
    "initializer_range": 0.02, "intermediate_size": 8640,
    "max_position_embeddings": 2048, "model_type": "llama",
    "num_attention_heads": 32, "num_hidden_layers": 26, "pad_token_id": 0,
    "rms_norm_eps": 1e-06, "tie_word_embeddings": False,
    "torch_dtype": "float16", "transformers_version": "4.28.0.dev0",
    "use_cache": True, "vocab_size": 32000,
}
OPENLLAMA_CAP, OPENLLAMA_PROMPT, OPENLLAMA_NEW_TOKENS = 2048, 1536, 64


def openllama_3b_config(num_layers: int = 26):
    """``openlm-research/open_llama_3b`` from its published ``config.json``
    (``OPENLLAMA_3B_HF_CONFIG``) through the port's
    ``hf_loader.config_from_hf``: vocab 32000, hidden 3200, 26 layers, 32
    heads of 100 over 32 kv heads (lane width 3200), MLP 8640,
    rms_norm_eps 1e-6, 2048 positions, untied embeddings; under
    ``serving_config()``'s pruning, quantization and engine settings
    sized to capacity 2048 (its context): batch 8, head pruning keeping 24
    of 32 kv heads.  K1 runs head_dim 100 in its <1, 128> instance; K2
    does not take head_dim 100 (``compact_gather.k2_takes``), so a prune
    compacts through the gather.  The weights are random (real ones are
    not in the repository)."""
    from spatten_tpu_torch.models.hf_loader import config_from_hf
    cfg = serving_config(num_layers, cap=OPENLLAMA_CAP)
    model = dataclasses.replace(config_from_hf(OPENLLAMA_3B_HF_CONFIG),
                                num_layers=num_layers)
    return dataclasses.replace(cfg, model=model).validate()


PARITY_BATCH, PARITY_PROMPT = 8, 1152
EARLY_DEPTH = 8         # the dense and parity paths' depth (see main)


def parity_config(num_layers: int = 32):
    """The JAX CLI's defaults (``run_spatten_tpu.py`` parse_args and its
    SpAttenConfig: start/important/recent 4/384/384, capacity 1024, V keep
    ratio 0.35, requant at 0.05, 4-bit, prefill chunk 128, head pruning
    off) with the upstream SpAtten-LLM pruning signal: the last step's
    raw scaled scores summed over queries, not accumulated
    (``importance_kind="presoftmax"``, ``cascade_accumulate=False``)."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=dataclasses.replace(ModelConfig.llama2_7b(),
                                  num_layers=num_layers),
        pruning=PruningConfig(start_size=4, important_size=384,
                              recent_size=384, v_keep_ratio=0.35,
                              importance_kind="presoftmax",
                              cascade_accumulate=False),
        quant=QuantConfig(enabled=True, enable_requant=True,
                          requant_threshold=0.05),
        engine=EngineConfig(max_batch_size=PARITY_BATCH, cache_capacity=1024,
                            prefill_chunk=128),
    ).validate()


def gate_configs() -> dict:
    """A configuration whose decode steps the card's gate sends off K1
    (``transformer.decode_uses_kernel``), as the JAX gate sends them to
    its jnp path: ``ModelConfig.tiny()``, whose fused lane width (2 kv
    heads of 8) is not a multiple of 128, under the pipeline of the tiny
    parity tests.  name -> (cfg, batch, prompt length, new tokens); the
    run prunes (head_dim 8 takes the gather, not K2)."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    tiny = SpAttenConfig(
        model=ModelConfig.tiny(),
        pruning=PruningConfig(start_size=2, important_size=8, recent_size=16,
                              v_block_size=8),
        quant=QuantConfig(requant_threshold=0.2),
        engine=EngineConfig(max_batch_size=2, cache_capacity=64,
                            prefill_chunk=8, decode_window=8),
    ).validate()
    return {"tiny (head_dim 8)": (tiny, 2, 72, 32)}


def device_scores_configs() -> dict:
    """Configurations whose K1 score plane [G, capacity] does not fit the
    kernel's shared memory, so the wrapper gives K1 a plane in device
    memory: a narrow model with Llama-2-70B's GQA group (8 query heads
    over 1 kv head of 128) at capacity 4096, which the JAX gate sends to
    its kernel (lane width 128).  name -> (cfg, batch, prompt length, new
    tokens); the run prunes (K2 moves its rows)."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, SpAttenConfig,
    )
    gqa8 = SpAttenConfig(
        model=ModelConfig(vocab_size=256, hidden_size=256, num_layers=2,
                          num_heads=8, num_kv_heads=1, head_dim=128,
                          intermediate_size=512),
        pruning=PruningConfig(v_block_size=64),
        engine=EngineConfig(max_batch_size=2, cache_capacity=4096,
                            decode_window=16),
    ).validate()
    return {"GQA 8 x 128, capacity 4096": (gqa8, 2, 2040, 32)}


def group_configs() -> dict:
    """Configurations whose GQA group K1 runs in a larger instance, under
    the pipeline of the tiny parity tests, f32, 2 layers, capacity 64, the
    GQA-8 model's vocab and MLP widths:

    * 6 query heads over 2 kv heads of 64 (group 3, lane width 128: the
      JAX gate sends it to its kernel), hidden 256, head pruning keeping
      1 of 2 kv heads; on the card K1 runs it in ``<4, 64>`` with 3 live
      rows;
    * Llama-3.1-405B's group: 16 query heads over 1 kv head of 128
      (lane width 128), hidden 2048; on the card K1 runs it in ``<8, 128>``
      with its score plane in device memory, as two chunks of 8 rows.

    name -> (cfg, batch, prompt length, new tokens); the prompt prunes in
    prefill."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    pruning = PruningConfig(start_size=2, important_size=8, recent_size=16,
                            v_block_size=8)
    engine = EngineConfig(max_batch_size=2, cache_capacity=64,
                          prefill_chunk=8, decode_window=8)
    gqa3 = SpAttenConfig(
        model=ModelConfig(vocab_size=256, hidden_size=256, num_layers=2,
                          num_heads=6, num_kv_heads=2, head_dim=64,
                          intermediate_size=512),
        pruning=dataclasses.replace(pruning, enable_head_pruning=True,
                                    head_keep=1),
        quant=QuantConfig(requant_threshold=0.2), engine=engine,
    ).validate()
    gqa16 = SpAttenConfig(
        model=ModelConfig(vocab_size=256, hidden_size=2048, num_layers=2,
                          num_heads=16, num_kv_heads=1, head_dim=128,
                          intermediate_size=512),
        pruning=pruning, quant=QuantConfig(requant_threshold=0.2),
        engine=engine,
    ).validate()
    return {GQA3_NAME: (gqa3, 2, 72, 32), GQA16_NAME: (gqa16, 2, 72, 32)}


GQA3_NAME = "GQA 3 (6 over 2 kv heads of 64), capacity 64"
GQA16_NAME = "GQA 16 (16 over 1 kv head of 128), capacity 64"


# ---------------------------------------------------------------- phase 2
def k1_bound(cfg, lengths, need, kept_tokens, alive, rung: int, bits: int):
    """(bound_ms, bound_by, bytes, ops, int8_ops) of one K1 call on these
    inputs: every input byte the function needs read once, every output
    written once; the operations priced by type, the products of int8
    queries with the int8 planes and, under pv_int8, of int8 weights with
    the V rows at the card's int8 rate, the rest (f32 products, the
    softmax) at its f32 rate.  A live head group reads the pass-1 plane
    rows serving its live tokens (packed msb rows, plus lsb2 rows for a
    6-bit layer, or int8 rows for an 8-bit layer or dense mode), the int8
    rows again when it
    requantizes, its K scale column, its importance column (read and
    written; in delta mode the rung's f32 delta written) and its kept V
    rows with their scales; every group writes the appended row (int8 K
    and V, the nibble and 2-bit bytes, scales)."""
    from spatten_tpu_torch.ops.quantize import pack_unit
    m, q = cfg.model, cfg.quant
    hkv, d, g = m.num_kv_heads, m.head_dim, m.q_heads_per_kv
    u = pack_unit(cfg.engine.cache_capacity)
    sb = 2 if q.scale_dtype == "bfloat16" else 4
    ib = 2 if cfg.pruning.importance_dtype == "bfloat16" else 4
    six = q.needs_lsb2
    byts = f32_ops = int8_ops = 0
    for bi, n in enumerate(lengths):
        units = range(rung // u)
        msb_rows = sum(min(max(n - k * u, 0), u // 2) for k in units)
        l2_rows = sum(min(max(n - k * u, 0), u // 4) for k in units)
        for h in range(hkv):
            byts += 2 * d + 2 * sb + 2 * d + (2 * d if six else 0)
            if not alive[bi][h]:
                continue
            fired = bool(need[bi][h])
            kept = int(kept_tokens[bi][h])
            p1 = {4: msb_rows * d, 6: msb_rows * d + l2_rows * d,
                  8: n * d}[bits]
            byts += p1 + (n * d if fired else 0)
            imp_b = (2 * n * ib if cfg.pruning.cascade_accumulate
                     else 4 * rung)
            byts += n * sb + imp_b + kept * (d + sb)
            passes = 1 + (1 if fired else 0)
            qk, pv = g * 2 * d * n * passes, g * 2 * d * kept
            int8_ops += (qk if q.quantize_queries else 0) \
                + (pv if q.pv_int8 else 0)
            f32_ops += g * 5 * n * passes \
                + (0 if q.quantize_queries else qk) + (0 if q.pv_int8 else pv)
    b = len(lengths)
    byts += 4 * b * (hkv * g * d * 2 + 2 * hkv * d) + b * hkv * 5
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = (f32_ops / F32_FLOPS + int8_ops / INT8_OPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", byts, f32_ops + int8_ops, int8_ops)


def k1_inputs(cfg, dev, gen, batch):
    from spatten_tpu_torch import kernel_checks as kc
    m = cfg.model
    st = kc.random_state(cfg, batch, gen, dev)
    q = torch.randn((batch, m.num_heads, 1, m.head_dim), generator=gen,
                    device=dev)
    kn = torch.randn((batch, m.num_kv_heads, 1, m.head_dim), generator=gen,
                     device=dev)
    vn = torch.randn((batch, m.num_kv_heads, 1, m.head_dim), generator=gen,
                     device=dev)
    return st, q, kn, vn


def k1_flags(cfg, layer: int, rung: int):
    """K1's keyword arguments for one layer under ``cfg`` (as
    ``transformer.run_layers`` passes them)."""
    from spatten_tpu_torch.models.transformer import v_keep_budgets
    q, p, m = cfg.quant, cfg.pruning, cfg.model
    cap = cfg.engine.cache_capacity
    kw = dict(sm_scale=1.0 / math.sqrt(m.head_dim), quant_enabled=q.enabled,
              v_keep=v_keep_budgets(cfg, cap), importance_ema=p.importance_ema,
              quantize_queries=q.quantize_queries, pv_int8=q.pv_int8,
              probs_bf16=q.probs_bf16, importance_kind=p.importance_kind,
              cap_override=rung if rung < cap else None)
    return kw


def k1_case(st, q, kn, vn, lengths, cfg, layer, rung, head_mask=None,
            delta_mode=False, **extra) -> dict:
    """Hold K1 against its plain version on one layer of ``st``."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    kw = dict(k1_flags(cfg, layer, rung), **extra)
    if cfg.quant.enabled and cfg.quant.layer_bits is not None:
        kw["quant_bits"] = st.quant_bits
    vb = cfg.pruning.v_block_size
    threshold = 0.0
    if cfg.quant.enabled:
        probe = st.clone()
        sp = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lengths, layer=layer,
            v_block_size=vb, importance_in=probe.importance,
            head_mask=head_mask, **kw)[1]
        threshold = kc.split_threshold(sp.max_prob)
        del probe
    res = kc.k1_pair(st, q, kn, vn, lengths, layer=layer,
                     threshold=threshold, v_block=vb, head_mask=head_mask,
                     delta_mode=delta_mode,
                     keep_blocks_for=lambda r: fd._v_keep_blocks(
                         kw["v_keep"], vb, r, layer), **kw)
    free()
    return dict(res, threshold=threshold, kw=kw)


def k1_case_logged(errs, lines, name, cfg, st, q, kn, vn, layer, rung,
                   lengths, **extra) -> dict:
    """``k1_case`` with its error and a log line appended to the phase's
    lists."""
    r = k1_case(st, q, kn, vn, lengths, cfg, layer, rung, **extra)
    errs.append(r["max_abs_err"])
    lines.append(f"{name} (layer {layer}, rung {rung}): fires {r['fired']}, "
                 f"dead groups {r['dead_groups']}, near rows "
                 f"{r['near_rows']}, max |out err| {r['max_abs_err']:.2e}, "
                 f"out bit-equal {r['out_exact']}/{r['out_total']}")
    return r


def time_k1(st, q, kn, vn, lengths, cfg, layers, rung, threshold,
            head_mask=None) -> dict:
    """Kernel and plain times of K1 at these inputs, walking ``layers`` so
    that each call finds its planes cold in L2, as decode does; the bound
    from the kernel's own decisions on the first layer."""
    from spatten_tpu_torch.ops import fused_decode as fd
    m = cfg.model
    kw = k1_flags(cfg, layers[0], rung)
    if cfg.quant.enabled and cfg.quant.layer_bits is not None:
        kw["quant_bits"] = st.quant_bits
    vb = cfg.pruning.v_block_size
    b, hq = q.shape[:2]
    nvb = rung // vb
    keep = torch.zeros((b, hq, nvb), dtype=torch.uint8, device=q.device)

    imp = st.importance if cfg.pruning.cascade_accumulate else None

    def call(fn, i, **extra):
        return fn(q, st.cache.k, st.cache.v, kn, vn, lengths,
                  requant_threshold=threshold, importance_in=imp,
                  v_block_size=vb, head_mask=head_mask,
                  **dict(kw, layer=layers[i % len(layers)]), **extra)

    stats = call(fd.fused_decode_attention, 0, keep_out=keep)[1]
    ms = device_ms(lambda i: call(fd.fused_decode_attention, i),
                   4 * len(layers))
    plain_ms = device_ms(lambda i: call(fd.fused_decode_attention_plain, i),
                         len(layers))
    group = m.q_heads_per_kv
    kb = fd._v_keep_blocks(kw["v_keep"], vb, rung, layers[0])
    keep_blk = (keep.bool() if kb else torch.ones_like(keep, dtype=torch.bool)
                ).reshape(b, m.num_kv_heads, group, nvb).any(2)
    live = torch.arange(rung, device=q.device)[None, None, :] \
        < lengths[:, None, None]
    kept = (keep_blk.repeat_interleave(vb, dim=-1) & live).sum(-1).tolist()
    if head_mask is None:
        alive = [[True] * m.num_kv_heads] * b
    else:
        alive = head_mask.reshape(m.num_kv_heads, group).any(-1)[None]\
            .expand(b, -1).tolist()
    bits = 8 if not cfg.quant.enabled else int(
        st.quant_bits[layers[0]]) if cfg.quant.layer_bits else 4
    bound_ms, bound_by, byts, ops, int8_ops = k1_bound(
        cfg, lengths.tolist(), stats.need_requant.tolist(), kept, alive,
        rung, bits)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=byts, ops=ops, int8_ops=int8_ops,
                fired=int(stats.need_requant.sum()))


def phase_k1_slice1(cfg, dev) -> dict:
    """K1 at the first slice's shapes (batch 4, capacity 1024, f32
    metadata, 4-bit, requant split, V pruning)."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    st, q, kn, vn = k1_inputs(cfg, dev, gen, 4)
    lengths = torch.tensor([1024, 900, 513, 77], dtype=torch.int32,
                           device=dev)
    cap = cfg.engine.cache_capacity
    res = k1_case(st, q, kn, vn, lengths, cfg, 5, cap)
    log(f"K1 vs plain, first slice shapes: ok (threshold "
        f"{res['threshold']:.6f} fires {res['fired']} of 128 heads; "
        f"near-margin heads {res['near_threshold']}, rows "
        f"{res['near_rows']}; max |out err| {res['max_abs_err']:.3e})")
    t = time_k1(st, q, kn, vn, lengths, cfg, list(range(cfg.model.num_layers)),
                cap, res["threshold"])
    log(f"K1 timing, first slice shapes: {t['ms']:.4f} ms kernel, "
        f"{t['plain_ms']:.4f} ms plain, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops, "
        f"{t['int8_ops']} int8)")
    del st
    free()
    return dict(max_abs_err=res["max_abs_err"], ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=None)


def serving_head_mask(cfg, gen, dev):
    """A 24-of-32 kv-head mask (as the serving policy keeps), as [Hq]."""
    m = cfg.model
    keep = torch.randperm(m.num_kv_heads, generator=gen, device=dev)[
        :cfg.pruning.head_keep]
    grp = torch.zeros(m.num_kv_heads, dtype=torch.bool, device=dev)
    grp[keep] = True
    return grp.repeat_interleave(m.q_heads_per_kv)


def phase_k1_serving(dev) -> dict:
    """K1 at the serving shapes: each flag alone, the serving and dense
    combinations, 6- and 8-bit layers; then timing at both rungs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b = SERVING_BATCH
    lens = {2048: [2048, 1900, 1601, 1200, 977, 800, 729, 33],
            4096: [4096, 3200, 3100, 2665, 2800, 2049, 1000, 1]}

    def L(r):
        return torch.tensor(lens[r], dtype=torch.int32, device=dev)

    serving = serving_config()
    plain_flags = dataclasses.replace(
        serving,
        quant=dataclasses.replace(serving.quant, quantize_queries=False,
                                  pv_int8=False, probs_bf16=False,
                                  scale_dtype="float32"),
        pruning=dataclasses.replace(serving.pruning,
                                    importance_dtype="float32"))
    hm = serving_head_mask(serving, gen, dev)
    errs, lines = [], []

    def run(name, cfg, st, q, kn, vn, layer, rung, **extra):
        return k1_case_logged(errs, lines, name, cfg, st, q, kn, vn, layer,
                              rung, L(rung), **extra)

    # each flag alone, over f32 metadata and the 4-bit plane
    st, q, kn, vn = k1_inputs(plain_flags, dev, gen, b)
    run("head_mask", plain_flags, st, q, kn, vn, 0, 4096, head_mask=hm)
    for flag in ("quantize_queries", "pv_int8", "probs_bf16"):
        run(flag, plain_flags, st, q, kn, vn, 0, 4096, **{flag: True})
    run("cap_override", plain_flags, st, q, kn, vn, 5, 2048)
    del st
    free()
    # bf16 metadata alone, then the serving combination at both rungs
    st, q, kn, vn = k1_inputs(serving, dev, gen, b)
    run("bf16_metadata", serving, st, q, kn, vn, 0, 4096,
        quantize_queries=False, pv_int8=False, probs_bf16=False)
    r2 = run("serving", serving, st, q, kn, vn, 5, 2048, head_mask=hm)
    r4 = run("serving", serving, st, q, kn, vn, 0, 4096, head_mask=hm)
    t2 = time_k1(st, q, kn, vn, L(2048), serving, list(range(2, 32)), 2048,
                 r2["threshold"], head_mask=hm)
    t4 = time_k1(st, q, kn, vn, L(4096), serving, [0, 1], 4096,
                 r4["threshold"], head_mask=hm)
    del st
    free()
    # the quant profile's 6- and 8-bit layers (lsb2 plane present)
    prof = profile_config(32)
    st, q, kn, vn = k1_inputs(prof, dev, gen, b)
    run("bits6", prof, st, q, kn, vn, 2, 2048, head_mask=hm)
    run("bits8", prof, st, q, kn, vn, 4, 2048, head_mask=hm)
    del st
    free()
    dense = dense_config()
    st, q, kn, vn = k1_inputs(dense, dev, gen, b)
    run("dense", dense, st, q, kn, vn, 0, 4096)
    del st
    free()
    log("K1 vs plain, serving shapes [32, 8, 4096, 4096]: ok\n  "
        + "\n  ".join(lines))
    for name, t in (("rung 2048, layers 2-31", t2), ("rung 4096, layers 0-1",
                                                     t4)):
        log(f"K1 timing, serving combination, {name}: {t['ms']:.4f} ms "
            f"kernel, {t['plain_ms']:.4f} ms plain, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}: {t['bytes']} B, "
            f"{t['ops']} ops, {t['int8_ops']} int8; {t['fired']} of 256 "
            "heads requantize)")
    return dict(max_abs_err=max(errs), ms=t2["ms"], plain_ms=t2["plain_ms"],
                bound_ms=t2["bound_ms"], bound_by=t2["bound_by"],
                library_ms=None,
                rung_4096=dict(ms=t4["ms"], plain_ms=t4["plain_ms"],
                               bound_ms=t4["bound_ms"],
                               bound_by=t4["bound_by"]))


def k1_shape_config(base, *, hq: int, hkv: int, d: int, cap: int,
                    layers: int = 2):
    """``base`` (its flags and pruning) at an attention shape of hq query
    heads over hkv kv heads of d, capacity cap, ``layers`` deep; head
    pruning keeps the serving share (3/4) of the kv heads."""
    from spatten_tpu_torch.config import ModelConfig
    model = dataclasses.replace(
        ModelConfig.llama2_7b(), num_layers=layers, num_heads=hq,
        num_kv_heads=hkv, head_dim=d, hidden_size=hq * d)
    return dataclasses.replace(
        base, model=model,
        engine=dataclasses.replace(base.engine, cache_capacity=cap),
        pruning=dataclasses.replace(base.pruning,
                                    head_keep=max(1, 3 * hkv // 4)),
    ).validate()


def partial_head_mask(hq: int, hkv: int, dev):
    """[Hq] rows: kv head 0's group alive, head 1's first row dead (a
    partly alive group), head 2's group (where there is one) dead, every
    other group alive."""
    hm = torch.ones((hkv, hq // hkv), dtype=torch.bool, device=dev)
    hm[1, 0] = False
    hm[2:3] = False
    return hm.reshape(hq)


def phase_k1_llama32(dev) -> dict:
    """K1 at Llama-3.2-3B's serving shapes (``llama32_3b_config()``: one
    layer of the stacked [28, 8, 4096, 1024] planes, group 3 in <4, 128>,
    6 of 8 kv heads alive, the serving flags): held against its plain
    version at both rungs, then timed at each over the layers of that
    rung."""
    from spatten_tpu_torch.ops import fused_decode as fd
    from spatten_tpu_torch.pruning.token_pruning import layer_capacity_groups
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    cfg = llama32_3b_config()
    lens = {2048: [2048, 1900, 1601, 1200, 977, 800, 729, 33],
            4096: [4096, 3200, 3100, 2665, 2800, 2049, 1000, 1]}
    layers = {r: list(range(a, b)) for a, b, r in layer_capacity_groups(cfg)}
    hm = serving_head_mask(cfg, gen, dev)
    st, q, kn, vn = k1_inputs(cfg, dev, gen, SERVING_BATCH)
    out, errs, lines = {}, [], []
    for rung in (2048, 4096):
        lengths = torch.tensor(lens[rung], dtype=torch.int32, device=dev)
        r = k1_case_logged(errs, lines, "Llama-3.2-3B serving", cfg, st, q,
                           kn, vn, layers[rung][0], rung, lengths,
                           head_mask=hm)
        out[rung] = time_k1(st, q, kn, vn, lengths, cfg, layers[rung], rung,
                            r["threshold"], head_mask=hm)
    del st
    free()
    log(f"K1 vs plain, Llama-3.2-3B shapes [28, 8, 4096, 1024] (GQA 3 in "
        f"<{fd.instance_group(3)}, 128>): ok\n  " + "\n  ".join(lines))
    for rung, t in out.items():
        log(f"K1 timing, Llama-3.2-3B, rung {rung}, layers "
            f"{layers[rung][0]}-{layers[rung][-1]}: {t['ms']:.4f} ms kernel, "
            f"{t['plain_ms']:.4f} ms plain, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}: {t['bytes']} B, {t['ops']} ops, "
            f"{t['int8_ops']} int8; {t['fired']} of 64 heads requantize; "
            f"{SERVING_BATCH * 8} CTAs)")
    t2, t4 = out[2048], out[4096]
    return dict(max_abs_err=max(errs), ms=t2["ms"], plain_ms=t2["plain_ms"],
                bound_ms=t2["bound_ms"], bound_by=t2["bound_by"],
                rung_4096=dict(ms=t4["ms"], plain_ms=t4["plain_ms"],
                               bound_ms=t4["bound_ms"],
                               bound_by=t4["bound_by"]))


def phase_k1_flags(dev) -> dict:
    """K1's remaining flags at the serving shapes (one layer of stacked
    [4, 8, 4096, 4096] planes, f32 metadata as the parity path keeps):
    presoftmax accumulated and in delta mode, prob in delta mode, rows
    that do not append (one of them empty), row stats with dead groups;
    then per-row importance at a GQA shape (32 query heads over 8 kv heads
    of 128); then K1's time under the parity flags at the parity shapes
    (batch 8, capacity 1024, delta mode, presoftmax)."""
    from spatten_tpu_torch.config import ModelConfig
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    b = SERVING_BATCH
    serving = serving_config(4)
    flags_cfg = dataclasses.replace(
        serving,
        quant=dataclasses.replace(serving.quant, quantize_queries=False,
                                  pv_int8=False, probs_bf16=False,
                                  scale_dtype="float32"),
        pruning=dataclasses.replace(serving.pruning,
                                    importance_dtype="float32"))
    lens = {2048: [2048, 1900, 1601, 1200, 977, 800, 729, 33],
            4096: [4096, 3200, 3100, 2665, 2800, 2049, 1000, 1]}
    hm = serving_head_mask(flags_cfg, gen, dev)
    app = torch.tensor([True, False, True, False, True, False, True, False],
                       device=dev)
    errs, lines = [], []

    def run(name, cfg, st, q, kn, vn, layer, rung, lengths=None, **extra):
        lengths = torch.tensor(lengths or lens[rung], dtype=torch.int32,
                               device=dev)
        k1_case_logged(errs, lines, name, cfg, st, q, kn, vn, layer, rung,
                       lengths, **extra)

    st, q, kn, vn = k1_inputs(flags_cfg, dev, gen, b)
    run("presoftmax accumulated", flags_cfg, st, q, kn, vn, 0, 4096,
        importance_kind="presoftmax")
    run("presoftmax delta", flags_cfg, st, q, kn, vn, 1, 2048,
        importance_kind="presoftmax", delta_mode=True, head_mask=hm)
    run("prob delta", flags_cfg, st, q, kn, vn, 0, 4096, delta_mode=True)
    run("append_mask (row 7 empty)", flags_cfg, st, q, kn, vn, 1, 2048,
        lengths=lens[2048][:-1] + [0], append_mask=app)
    run("return_row_stats", flags_cfg, st, q, kn, vn, 0, 4096,
        head_mask=hm, return_row_stats=True, delta_mode=True,
        append_mask=app, importance_kind="presoftmax")
    del st
    free()
    gqa = dataclasses.replace(
        flags_cfg, model=dataclasses.replace(ModelConfig.llama2_7b(),
                                             num_layers=2, num_kv_heads=8))
    st, q, kn, vn = k1_inputs(gqa, dev, gen, b)
    for kind in ("prob", "presoftmax"):
        run(f"GQA 32/8 per_row_importance {kind}", gqa, st, q, kn, vn, 1,
            4096, lengths=lens[4096][:-1] + [0], delta_mode=True,
            per_row_importance=True, return_row_stats=True,
            append_mask=app, importance_kind=kind)
    del st
    free()
    log("K1 vs plain, remaining flags at the serving shapes: ok\n  "
        + "\n  ".join(lines))
    # the parity path's K1 calls: [32, 8, 1024, 4096] planes, lengths as
    # decode finds them after prefill's prunes
    par = parity_config()
    st, q, kn, vn = k1_inputs(par, dev, gen, PARITY_BATCH)
    plen = torch.tensor([900, 890, 880, 870, 860, 850, 840, 830],
                        dtype=torch.int32, device=dev)
    r = k1_case(st, q, kn, vn, plen, par, 3, 1024, delta_mode=True)
    t = time_k1(st, q, kn, vn, plen, par, list(range(32)), 1024,
                r["threshold"])
    del st
    free()
    log(f"K1 timing, parity flags (presoftmax, delta mode, batch 8, "
        f"capacity 1024): {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms "
        f"plain, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
        f"{t['bytes']} B, {t['ops']} ops, {t['int8_ops']} int8; "
        f"{t['fired']} of 256 heads requantize)")
    return dict(max_abs_err=max(errs + [r["max_abs_err"]]),
                parity=dict(ms=t["ms"], plain_ms=t["plain_ms"],
                            bound_ms=t["bound_ms"], bound_by=t["bound_by"]))


# ---------------------------------------------------------------- phase 3
def phase_k2(dev, *, b, cap, hkv, d, keep_max, window, lengths, triggered,
             keep_count, start_size=4) -> dict:
    from spatten_tpu_torch.ops import compact_gather as cg
    f = hkv * d
    rng = np.random.default_rng(SEED)
    lengths = np.asarray(lengths, np.int32)
    triggered = np.asarray(triggered, np.int32)
    keep_count = np.asarray(keep_count, np.int32)
    idx = np.zeros((b, hkv, keep_max), np.int32)
    for bi in range(b):
        n = keep_count[bi]
        for h in range(hkv):
            mid = np.sort(rng.choice(np.arange(start_size, lengths[bi]),
                                     n - start_size, replace=False))
            idx[bi, h, :n] = np.concatenate([np.arange(start_size), mid])
    keep_idx = torch.from_numpy(idx).to(dev)
    lens_t = torch.from_numpy(lengths).to(dev)
    trig_t = torch.from_numpy(triggered).to(dev)
    kc_t = torch.from_numpy(keep_count).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    n_rot = 8                                  # planes walked for timing
    k_all = torch.randint(-127, 128, (n_rot, b, cap, f), generator=gen,
                          device=dev, dtype=torch.int8)
    v_all = torch.randint(-127, 128, (n_rot, b, cap, f), generator=gen,
                          device=dev, dtype=torch.int8)
    k0, v0 = k_all[0].clone(), v_all[0].clone()

    kk, vk = k0.clone(), v0.clone()
    kp, vp = k0.clone(), v0.clone()
    cg.gather_compact_rows(kk, vk, keep_idx, lens_t, trig_t,
                           keep_count=kc_t, window=window)
    cg.gather_compact_rows_plain(kp, vp, keep_idx, lens_t, trig_t,
                                 keep_count=kc_t, window=window)
    torch.cuda.synchronize()
    for bi in range(b):
        n = int(keep_count[bi]) if triggered[bi] else cap
        for a, c, o in ((kk, kp, k0), (vk, vp, v0)):
            check(torch.equal(a[bi, :n], c[bi, :n]),
                  f"K2 live rows differ (b={bi})")
            check(torch.equal(a[bi, n:], o[bi, n:]),
                  f"K2 touched rows past the keep count (b={bi})")

    def kernel_call(i):
        cg.gather_compact_rows(k_all[i % n_rot], v_all[i % n_rot], keep_idx,
                               lens_t, trig_t, keep_count=kc_t, window=window)

    def plain_call(i):
        cg.gather_compact_rows_plain(
            k_all[i % n_rot], v_all[i % n_rot], keep_idx, lens_t, trig_t,
            keep_count=kc_t, window=window)

    gidx = keep_idx.to(torch.int64).transpose(1, 2)[..., None].expand(
        b, keep_max, hkv, d)

    def library_call(i):
        torch.gather(k_all[i % n_rot].view(b, cap, hkv, d), 1, gidx)
        torch.gather(v_all[i % n_rot].view(b, cap, hkv, d), 1, gidx)

    ms = device_ms(kernel_call, 4 * n_rot)
    plain_ms = device_ms(plain_call, n_rot)
    library_ms = device_ms(library_call, 4 * n_rot)
    moved = 0
    for bi in range(b):
        if triggered[bi]:
            n = keep_count[bi]
            moved += int((idx[bi, :, :n] != np.arange(n)[None]).sum())
    byts = moved * d * 2 * 2 + int((keep_count * triggered).sum()) * hkv * 4
    bound_ms = byts / HBM_BYTES_PER_S * 1e3
    log(f"K2 [{b}, {cap}, {f}] vs plain: byte-exact on live rows, untouched "
        f"elsewhere; {ms:.4f} ms kernel, {plain_ms:.4f} ms plain, "
        f"{library_ms:.4f} ms torch.gather (K and V), bound {bound_ms:.4f} ms "
        f"(bytes: {moved} moved head rows, {byts} B)")
    del k_all, v_all
    free()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes", library_ms=library_ms)


# ---------------------------------------------------------------- phase 4
SPLIT_N, SPLIT_CL = 4, 2048
SPLIT_TOL = dict(atol=1e-4, rtol=1e-4)


def wall_ms(fn, n: int, devices) -> float:
    """Host-clock ms of one call of ``fn(i)`` over n calls, every card of
    ``devices`` synchronised before and after (work spread over cards
    from one controller, whose launches on one card a single card's
    events cannot bracket)."""
    def sync():
        for d in set(devices):
            torch.cuda.synchronize(d)
    fn(0)
    sync()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    sync()
    return (time.perf_counter() - t0) / n * 1e3


def phase_split_k(dev, devices=None) -> dict:
    """Split-K decode: 4 shards of 2048 tokens on ``devices`` (default:
    all on ``dev``, one card), batch
    8, 32 query heads of 128 over 32 (MHA) or 8 (GQA) kv heads, 4-bit
    planes, no requant and no V pruning (the JAX split-K tests' flags:
    shard-local requant and V budgets differ from global ones by design).
    Shards 0-2 are full and the owner partly live.  Each step is held
    against one unsharded K1 call over the globally packed cache of the
    same tokens: out, the appended row (exact), the other shards' planes
    (untouched) and the importance live prefix.  Then ``split_k_prune``
    (4004 kept tokens: shards 2-3 left empty) and one more step against
    unsharded K1 over the same kept set."""
    from spatten_tpu_torch.ops import fused_decode as fd
    from spatten_tpu_torch.ops import quantize as qz
    from spatten_tpu_torch.parallel import split_k as sk
    n, cl, b, hq, d = SPLIT_N, SPLIT_CL, SERVING_BATCH, 32, 128
    cap = n * cl
    mesh = sk.make_kv_mesh(devices or [dev] * n)
    cards = len(set(mesh.devices))
    kw = dict(sm_scale=1.0 / math.sqrt(d), quant_enabled=True,
              v_block_size=64)
    own = torch.tensor([2048, 1900, 1500, 1025, 777, 300, 64, 1],
                       dtype=torch.int32)
    out = {}
    for hkv in (32, 8):
        name = "MHA 32/32" if hkv == hq else f"GQA {hq}/{hkv}"
        gen = torch.Generator(device=dev).manual_seed(SEED + hkv)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)

        q, kn, vn = randn(b, hq, 1, d), randn(b, hkv, 1, d), randn(b, hkv, 1, d)
        kx, vx = randn(b, hkv, cap, d), randn(b, hkv, cap, d)
        imp0 = torch.rand((b, hkv, cap), generator=gen, device=dev)
        ks = sk.quantize_sharded(kx, mesh)
        vs = sk.quantize_sharded(vx, mesh, with_msb=False)
        kg, vg = qz.quantize(kx), qz.quantize(vx, with_msb=False)
        del kx, vx
        local = torch.cat([torch.full((n - 1, b), cl, dtype=torch.int32),
                           own[None]]).to(dev)
        glob = local.sum(0)
        imp_s = sk.shard_tokens(imp0, mesh, -1)
        before = [[x.clone() for x in (s_.full, s_.msb, s_.scale)]
                  for s_ in ks[:n - 1]]
        fd.fused_decode_attention.launches = 0
        got, ks, vs, imp_s, _, _ = sk.split_k_decode_fused(
            q, ks, vs, kn, vn, local, mesh, importance_in=imp_s, **kw)
        launches = fd.fused_decode_attention.launches
        check(launches == n, f"split-K {name}: K1 launched {launches} "
              f"times for {n} shards")
        imp_g = imp0.clone()
        want = fd.fused_decode_attention(q, kg, vg, kn, vn, glob,
                                         importance_in=imp_g, **kw)[0]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(bool(torch.allclose(got, want, **SPLIT_TOL)),
              f"split-K {name}: out differs from unsharded K1 ({err:.3e})")
        joined = sk.join_kv(ks)
        check(torch.equal(joined.full, kg.full)
              and torch.equal(joined.scale, kg.scale),
              f"split-K {name}: planes differ from unsharded K1's")
        check(all(torch.equal(x, y) for i in range(n - 1) for x, y in
                  zip((ks[i].full, ks[i].msb, ks[i].scale), before[i])),
              f"split-K {name}: a shard that does not own the tail changed")
        imp = sk.join_tokens(imp_s)
        for bi in range(b):
            m = int(glob[bi])
            check(bool(torch.allclose(imp[bi, :, :m], imp_g[bi, :, :m],
                                      atol=1e-5, rtol=1e-4)),
                  f"split-K {name}: importance differs (b={bi})")

        def step(_i):
            sk.split_k_decode_fused(q, ks, vs, kn, vn, local, mesh,
                                    importance_in=imp_s, **kw)

        def unsharded(_i):
            fd.fused_decode_attention(q, kg, vg, kn, vn, glob,
                                      importance_in=imp_g, **kw)

        def shard0(_i):
            fd.fused_decode_attention(
                q, ks[0], vs[0], kn, vn, local[0], append_mask=torch.zeros(
                    b, dtype=torch.bool, device=dev), return_row_stats=True,
                per_row_importance=hq > hkv, **kw)

        ms_split = (device_ms(step, 8) if cards == 1
                    else wall_ms(step, 8, mesh.devices))
        ms_full = device_ms(unsharded, 8)
        ms_shard = device_ms(shard0, 16)
        # prune: 4 + 3000 + 1000 kept; shards 2 and 3 hold no live token
        ks, vs, imp_s, local = sk.split_k_prune(
            ks, vs, imp_s, local, mesh, start_size=4, important_size=3000,
            recent_size=1000)
        check(local[:, 0].tolist() == [2048, 1956, 0, 0],
              f"split-K {name}: local lengths after the prune "
              f"{local[:, 0].tolist()}")
        local[1] += 1                          # the owner of slot 4004
        got2 = sk.split_k_decode_fused(q, ks, vs, kn, vn, local, mesh,
                                       importance_in=imp_s, **kw)[0]
        kg2, vg2 = sk.join_kv(ks), sk.join_kv(vs)
        kg2 = kg2._replace(msb=qz.pack_msb(kg2.full))
        # the shards already hold the appended row: the unsharded call
        # writes the same bytes at the same slot
        want2 = fd.fused_decode_attention(q, kg2, vg2, kn, vn, local.sum(0),
                                          track_importance=False, **kw)[0]
        torch.cuda.synchronize()
        err2 = float((got2 - want2).abs().max())
        check(bool(torch.isfinite(got2).all()), f"split-K {name}: non-finite "
              "output over empty shards")
        check(bool(torch.allclose(got2, want2, **SPLIT_TOL)),
              f"split-K {name}: out after the prune differs ({err2:.3e})")
        where = "one card" if cards == 1 else f"{cards} cards"
        log(f"split-K {name} ({n} shards x {cl} tokens on {where}, batch "
            f"{b}): vs unsharded K1 max |out err| {err:.2e}, planes exact, "
            f"importance within 1e-5/1e-4; after split_k_prune (local "
            f"lengths with the new token {local[:, 0].tolist()}) max |out err| "
            f"{err2:.2e}; "
            + ("device" if cards == 1 else "host clock, every card synced,")
            + f" {ms_split:.4f} ms per split-K step ({n} K1 launches + "
            f"recombination) vs device {ms_full:.4f} ms unsharded K1 (printed,"
            f" no claim); one shard's K1 call {ms_shard:.4f} ms")
        out[name] = dict(max_abs_err=max(err, err2), step_ms=ms_split,
                         unsharded_ms=ms_full, shard_ms=ms_shard,
                         launches=launches, cards=cards)
        del ks, vs, kg, vg, kg2, vg2, imp_s, imp_g
        free()
    return out


def phase_launch_probe(dev) -> dict:
    """P1-P5 against their plain versions (exact), then the launch probe's
    timings with the yardsticks; the host time of one K1 wrapper call at
    the serving shapes (layer 2 of stacked serving planes, rung 2048, the
    serving flags) rides along."""
    from spatten_tpu_torch.ops import fused_decode as fd
    from spatten_tpu_torch.tools import launch_overhead as lo
    ops = lo.inputs(dev, SEED)
    errs = lo.check_probes(ops)
    log("launch probe: P1-P5 equal their plain versions exactly")
    cfg = serving_config(4)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    st, q, kn, vn = k1_inputs(cfg, dev, gen, SERVING_BATCH)
    lengths = torch.full((SERVING_BATCH,), 1500, dtype=torch.int32,
                         device=dev)
    hm = serving_head_mask(cfg, gen, dev)
    kw = dict(k1_flags(cfg, 2, 2048), requant_threshold=0.05,
              v_block_size=cfg.pruning.v_block_size, head_mask=hm,
              layer=2, importance_in=st.importance)

    def k1_call():
        fd.fused_decode_attention(q, st.cache.k, st.cache.v, kn, vn, lengths,
                                  **kw)

    for k, _, _, _ in lo.PROBES.values():
        k.launches = 0
    res = lo.measure(ops, k1_call)
    counts = {pid: k.launches for pid, (k, _, _, _) in lo.PROBES.items()}
    check(all(c > 0 for c in counts.values()),
          f"launch probe: a probe was never launched ({counts})")
    for line in lo.report(res):
        log(f"  {line}")
    del st
    free()
    return dict(res=res, errs=errs, counts=counts)


def phase_gate(dev) -> dict:
    """The decode gate on the card: ``generate`` on ``gate_configs()``
    (off K1: its launch count must stay 0), on ``device_scores_configs()``
    (K1 with its score plane in device memory) and on ``group_configs()``
    (GQA group 3, which K1 runs in <4, 64>), each on K1 with one launch
    per layer and step; f32 weights from the seed, each call of the run
    held against its replay on the CPU
    (``kernel_checks.check_against_cpu``)."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.models import transformer as tr
    out = {}
    runs = {**gate_configs(), **device_scores_configs(), **group_configs()}
    for name, (cfg, batch, plen, new) in runs.items():
        params = tr.init_params(cfg.model, SEED, dtype=torch.float32,
                                device="cpu")
        prompt = np.random.default_rng(SEED).integers(
            0, cfg.model.vocab_size, (batch, plen))
        r = kc.check_against_cpu(cfg, params, prompt, new, dev)
        path = ("K1" if tr.decode_uses_kernel(cfg, "cuda")
                else "the reference path")
        log(f"gate, {name}: generate on the card through {path} (K1 "
            f"launches {r['k1']}, K2 launches {r['k2']}, prune points "
            f"{r['prune_points']}, requant events {r['requant_events']}); "
            f"each of {r['calls']} calls vs its CPU replay: logits max "
            f"|diff| {r['max_logit_err']:.2e} (tolerance "
            f"{kc.CPU_REPLAY_LOGIT_TOL}); tokens equal where the top-2 "
            f"margin is clear ({r['clear_share']:.3f} of steps)")
        out[name] = r
        free()
    return out


def phase_k1_device_scores(dev) -> dict:
    """K1 with its score plane in device memory, at full attention widths
    under the serving flags (f32 metadata, depth 2): Llama-2-70B's (64
    query heads over 8 kv heads of 128) at capacity 4096, batch 8, and
    Llama-3-8B's (32 over 8) at capacity 16384, batch 2; each held against
    its plain version, then timed."""
    from spatten_tpu_torch.config import ModelConfig
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    base = serving_config(2)
    shapes = {
        "Llama-2-70B attention, capacity 4096": (
            dict(hidden_size=8192, num_heads=64, intermediate_size=28672),
            4096, [4096, 3900, 3500, 3001, 2049, 1500, 700, 33]),
        "Llama-3-8B attention, capacity 16384": (
            dict(intermediate_size=14336), 16384, [16384, 9001]),
    }
    out = {}
    for name, (widths, cap, lengths) in shapes.items():
        model = dataclasses.replace(ModelConfig.llama2_7b(), num_layers=2,
                                    num_kv_heads=8, **widths)
        cfg = dataclasses.replace(
            base, model=model,
            engine=dataclasses.replace(base.engine, cache_capacity=cap,
                                       max_batch_size=len(lengths)),
            quant=dataclasses.replace(base.quant, scale_dtype="float32"),
            pruning=dataclasses.replace(base.pruning,
                                        importance_dtype="float32"),
        ).validate()
        vb = cfg.pruning.v_block_size
        check(not fd.scores_in_smem(model.q_heads_per_kv, 128, cap, vb),
              f"{name}: the score plane fits shared memory")
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        r = k1_case(st, q, kn, vn, lens, cfg, 0, cap)
        t = time_k1(st, q, kn, vn, lens, cfg, [0, 1], cap, r["threshold"])
        del st
        free()
        log(f"K1, score plane in device memory, {name} (GQA "
            f"{model.q_heads_per_kv}, v_block {vb}, batch {len(lengths)}): "
            f"fires {r['fired']}, near rows {r['near_rows']}, max |out err| "
            f"{r['max_abs_err']:.2e}; {t['ms']:.4f} ms kernel, "
            f"{t['plain_ms']:.4f} ms plain, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']})")
        out[name] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"])
    return out


# K1 at GQA groups past its largest instance, which it runs in <8, 128>
# with the score plane in device memory as chunks of 8 query rows: name
# -> (query heads, kv heads, head_dim, layer bits or None, rungs).
# Llama-3.1-405B's attention from meta-llama/Llama-3.1-405B's config.json
# (128 query heads over 8 kv heads of 128).
WIDE_GROUP_CASES = {
    "Llama-3.1-405B attention (GQA 16: 128 over 8 x 128)": (
        128, 8, 128, None, (2048, 4096)),
    "GQA 12 (48 over 4 x 128), 6-bit": (48, 4, 128, (6, 6), (4096,)),
}
WIDE_GROUP_LENGTHS = {2048: [2048, 1601, 977, 33], 4096: [4096, 3100, 2049, 1]}


def phase_k1_wide_groups(dev) -> dict:
    """K1 at GQA groups past 8 (``WIDE_GROUP_CASES``), batch 4, capacity
    4096, depth 2, a partly head-masked group (and a dead one): under the
    serving flags at each rung, and at Llama-3.1-405B's attention once
    more in presoftmax delta mode (f32 metadata, as ``phase_k1_flags``);
    each held against its plain version, then timed against its
    bound."""
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out, errs, lines = {}, [], []
    for name, (hq, hkv, d, bits, rungs) in WIDE_GROUP_CASES.items():
        cfg = k1_shape_config(serving_config(2, layer_bits=bits), hq=hq,
                              hkv=hkv, d=d, cap=SERVING_CAP)
        group, vb = hq // hkv, cfg.pruning.v_block_size
        plan = fd.k1_plan(group, d, SERVING_CAP, vb)
        check(plan.inst == 8 and plan.rows == 16 and not plan.scores_in_smem,
              f"{name}: plan {plan}")
        st, q, kn, vn = k1_inputs(cfg, dev, gen, 4)
        hm = partial_head_mask(hq, hkv, dev)
        res = {}
        for rung in rungs:
            lengths = torch.tensor(WIDE_GROUP_LENGTHS[rung],
                                   dtype=torch.int32, device=dev)
            r = k1_case_logged(errs, lines, f"{name} in <8, 128> ({plan.rows}"
                               f" rows), serving flags", cfg, st, q, kn, vn,
                               0, rung, lengths, head_mask=hm)
            t = time_k1(st, q, kn, vn, lengths, cfg, [0, 1], rung,
                        r["threshold"], head_mask=hm)
            lines.append(f"  timing, rung {rung}: {t['ms']:.4f} ms kernel, "
                         f"{t['plain_ms']:.4f} ms plain, bound "
                         f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                         f"{t['bytes']} B, {t['ops']} ops, {t['int8_ops']} "
                         f"int8; {t['fired']} of {4 * hkv} heads "
                         f"requantize; {4 * hkv} CTAs)")
            res[rung] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                             bound_by=t["bound_by"], bytes=t["bytes"],
                             ops=t["ops"], int8_ops=t["int8_ops"])
        if bits is None:
            flat = dataclasses.replace(
                cfg,
                quant=dataclasses.replace(cfg.quant, quantize_queries=False,
                                          pv_int8=False, probs_bf16=False,
                                          scale_dtype="float32"),
                pruning=dataclasses.replace(cfg.pruning,
                                            importance_dtype="float32"))
            del st
            free()
            st, q, kn, vn = k1_inputs(flat, dev, gen, 4)
            k1_case_logged(errs, lines, f"{name}, presoftmax delta", flat,
                           st, q, kn, vn, 1, 2048,
                           torch.tensor(WIDE_GROUP_LENGTHS[2048],
                                        dtype=torch.int32, device=dev),
                           head_mask=hm, importance_kind="presoftmax",
                           delta_mode=True)
        out[name] = res
        del st
        free()
    log("K1 vs plain, GQA groups past 8: ok\n  " + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# K1 at windows whose plan passes 227 KB even with the score plane in
# device memory, so its per-V-block arrays lie in device memory too:
# name -> (query heads, kv heads, capacity, v_block, lengths); head_dim
# 128, f32 metadata, the serving flags' V pruning (a quarter of the
# blocks kept)
LONG_WINDOW_CASES = {
    "1 kv head x GQA 8 x 128, 65536 tokens, v_block 16": (
        8, 1, 65536, 16, [65536, 40001]),
    "2 kv heads x GQA 1 x 128, 131072 tokens, v_block 8": (
        2, 2, 131072, 8, [131072]),
}


def peaked_k1_inputs(cfg, dev, gen, lengths, hot_blocks: int):
    """K1 inputs over ``cfg``'s planes (``kernel_checks.random_state``)
    whose attention is peaked on ``hot_blocks`` V blocks of each (row, kv
    head): the queries of a kv head's group share a direction u (plus
    0.1 noise), and the keys of the hot blocks (drawn among the row's
    live blocks) are u / 2 over keys of 0.1 noise.  Over tens of
    thousands of tokens random inputs give every row k-th and (k+1)-th
    block masses within ``kernel_checks.DECISION_MARGIN``, which the
    rules exclude; with exactly the kept count of hot blocks the keep
    decisions are clear (hot block masses ~1e-4, cold ones ~1e-6)."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import quantize as qz
    m, cap = cfg.model, cfg.engine.cache_capacity
    vb, b = cfg.pruning.v_block_size, len(lengths)
    hkv, d, g = m.num_kv_heads, m.head_dim, m.q_heads_per_kv
    st = kc.random_state(cfg, b, gen, dev)
    u = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    q = u.repeat_interleave(g, dim=1) + 0.1 * torch.randn(
        (b, hkv * g, 1, d), generator=gen, device=dev)
    k = 0.1 * torch.randn((b, hkv, cap, d), generator=gen, device=dev)
    for bi, n in enumerate(lengths):
        for h in range(hkv):
            hot = torch.randperm(n // vb - 1, generator=gen,
                                 device=dev)[:hot_blocks]
            cols = (hot[:, None] * vb + torch.arange(vb, device=dev)).ravel()
            k[bi, h, cols] += 0.5 * u[bi, h, 0]
    src = qz.quantize(k, with_msb=True,
                      with_lsb2=st.cache.k.lsb2 is not None)
    for name in ("full", "msb", "scale", "lsb2"):
        dst = getattr(st.cache.k, name)
        if dst is not None:
            dst.copy_(getattr(src, name)[None])
    kn = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    vn = torch.randn((b, hkv, 1, d), generator=gen, device=dev)
    return st, q, kn, vn


def phase_k1_long_windows(dev) -> dict:
    """K1 at ``LONG_WINDOW_CASES`` on peaked inputs (``peaked_k1_inputs``)
    with f32 and with bf16 scales and importance (the serving default):
    held against its plain version with every head requantizing
    (threshold 1.0: the max probabilities, ~1e-5 apart at these windows,
    leave no split clear of the rules' margin) and with none (threshold
    0.0), then timed against its bound (depth 2) at threshold 1.0."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    out, errs, lines = {}, [], []
    for case, (hq, hkv, cap, vb, lengths) in LONG_WINDOW_CASES.items():
        base = k1_shape_config(serving_config(2, cap=cap), hq=hq, hkv=hkv,
                               d=128, cap=cap)
        plan = fd.k1_plan(hq // hkv, 128, cap, vb)
        check(not plan.scores_in_smem and not plan.blocks_in_smem,
              f"{case}: plan {plan}")
        for meta, tag in (("float32", "f32"), ("bfloat16", "bf16")):
            name = f"{case}, {tag} metadata"
            cfg = dataclasses.replace(
                base,
                quant=dataclasses.replace(base.quant, scale_dtype=meta),
                pruning=dataclasses.replace(base.pruning, v_block_size=vb,
                                            importance_dtype=meta),
            ).validate()
            kw = k1_flags(cfg, 0, cap)
            kb = fd._v_keep_blocks(kw["v_keep"], vb, cap, 0)
            check(kb > 0, f"{name}: {kb} kept blocks")
            st, q, kn, vn = peaked_k1_inputs(cfg, dev, gen, lengths, kb)
            lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
            for threshold, fires in ((1.0, hkv * len(lengths)), (0.0, 0)):
                r = kc.k1_pair(st, q, kn, vn, lens, layer=0,
                               threshold=threshold, v_block=vb,
                               keep_blocks_for=lambda _: kb, **kw)
                check(r["near_rows"] < hq * len(lengths)
                      and r["fired"] == fires,
                      f"{name}, threshold {threshold}: {r}")
                errs.append(r["max_abs_err"])
                lines.append(
                    f"{name}, V-block arrays in device memory (layer 0, "
                    f"{kb} of {cap // vb} blocks kept), threshold "
                    f"{threshold}: fires {r['fired']}, near rows "
                    f"{r['near_rows']}, max |out err| "
                    f"{r['max_abs_err']:.2e}")
            t = time_k1(st, q, kn, vn, lens, cfg, [0, 1], cap, 1.0)
            lines.append(
                f"  timing: {t['ms']:.4f} ms kernel, {t['plain_ms']:.4f} ms"
                f" plain, bound {t['bound_ms']:.4f} ms ({t['bound_by']}: "
                f"{t['bytes']} B, {t['ops']} ops, {t['int8_ops']} int8; "
                f"{t['fired']} heads "
                f"requantize; {len(lengths) * hkv} CTAs, {plan.smem} B of "
                "shared memory each)")
            out[name] = dict(max_abs_err=max(errs[-2:]), ms=t["ms"],
                             plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                             bound_by=t["bound_by"], bytes=t["bytes"],
                             ops=t["ops"])
            del st
            free()
    log("K1 vs plain, long windows: ok\n  " + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# K1 at the GQA groups it runs in a larger instance (3 in <4, D>; 5, 6
# and 7 in <8, D>): name -> (query heads, kv heads, head_dim, capacity,
# rung, lengths).  The instance's shared-memory plan puts the score plane
# in shared memory for the first eight and in device memory for the rest.
GROUP_CASES = {
    **{f"GQA {g} ({4 * g} over 4 x {d})": (4 * g, 4, d, 4096, 2048,
                                          [2048, 1501, 700, 33])
       for g in (3, 5, 6, 7) for d in (64, 128)},
    "Llama-3.2-3B attention (GQA 3), capacity 16384": (
        24, 8, 128, 16384, 16384, [16384, 8193]),
    "Qwen2.5-14B attention (GQA 5), capacity 8192": (
        40, 8, 128, 8192, 8192, [8192, 4097]),
    "GQA 6 (12 over 2 x 64), capacity 8192": (
        12, 2, 64, 8192, 8192, [8192, 4097]),
    "Qwen2-7B attention (GQA 7), capacity 16384": (
        28, 4, 128, 16384, 16384, [16384, 8193]),
}


def phase_k1_groups(dev) -> dict:
    """K1 at the GQA groups 3, 5, 6 and 7 (``GROUP_CASES``), depth 2, a
    partly head-masked group in each: under the serving flags at head_dim
    64 and 128 over 4 kv heads (batch 4, rung 2048 of 4096; score plane
    in shared memory), then with the score plane in device memory under
    the serving flags with f32 metadata (batch 2) at Llama-3.2-3B's and
    Qwen2-7B's attention (capacity 16384), Qwen2.5-14B's and group 6
    (8192); each held against its plain version."""
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    errs, lines = [], []
    for name, (hq, hkv, d, cap, rung, lengths) in GROUP_CASES.items():
        cfg = k1_shape_config(serving_config(2), hq=hq, hkv=hkv, d=d,
                              cap=cap)
        inst, vb = fd.instance_group(hq // hkv), cfg.pruning.v_block_size
        in_smem = fd.scores_in_smem(inst, d, rung, vb)
        if not in_smem:
            cfg = dataclasses.replace(
                cfg,
                quant=dataclasses.replace(cfg.quant, scale_dtype="float32"),
                pruning=dataclasses.replace(cfg.pruning,
                                            importance_dtype="float32"))
        check(in_smem is (rung == 2048), f"{name}: score plane in "
              f"{'shared' if in_smem else 'device'} memory")
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        k1_case_logged(
            errs, lines, f"{name} in <{inst}, {d}>, plane in "
            f"{'shared' if in_smem else 'device'} memory", cfg, st, q, kn,
            vn, 1, rung, torch.tensor(lengths, dtype=torch.int32,
                                      device=dev),
            head_mask=partial_head_mask(hq, hkv, dev))
        del st
        free()
    log("K1 vs plain, GQA groups in larger instances: ok\n  "
        + "\n  ".join(lines))
    return dict(max_abs_err=max(errs))


# K1 at head dims off its instances: name -> (query heads, kv heads,
# head_dim, capacity, batch lengths, layer bits of a 4-layer stack)
HEAD_DIM_CASES = {
    "OpenLLaMA-3B attention (32 over 32 x 100)": (
        32, 32, 100, OPENLLAMA_CAP,
        [2048, 1900, 1601, 1200, 977, 800, 729, 33], (4, 6, 8, 4)),
    "head_dim 80 (32 over 8), capacity 4096": (
        32, 8, 80, 4096, [4096, 3001, 2049, 1500, 977, 700, 64, 1],
        (4, 6, 8, 4)),
    "head_dim 96, GQA 3 (12 over 4), capacity 4096": (
        12, 4, 96, 4096, [4096, 3001, 2049, 1500, 977, 700, 64, 1],
        (4, 6, 8, 4)),
    # the score plane in device memory: <4, 128> at 16384 tokens
    "head_dim 80 (32 over 8), capacity 16384": (
        32, 8, 80, 16384, [16384, 9001], (4, 6, 8, 4)),
    "head_dim 96, GQA 3 (12 over 4), capacity 16384": (
        12, 4, 96, 16384, [16384, 8193], (4, 6, 8, 4)),
}


def phase_k1_head_dims(dev) -> dict:
    """K1 at head dims it runs in a larger instance dim (``HEAD_DIM_CASES``:
    OpenLLaMA-3B's 100, 80 and 96 with GQA 3, each in <G, 128>), under the
    serving flags at a stack of four layers of 4, 6, 8 and 4 bits, a
    serving head mask: held against its plain version on the 4-, 6- and
    8-bit layers (every plane byte exact, the neighbouring heads' lanes
    included), then timed on each against its bound.  The long windows
    put the score plane in device memory (f32 metadata, as
    ``phase_k1_device_scores``)."""
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    out, errs, lines = {}, [], []
    for name, (hq, hkv, d, cap, lengths, bits) in HEAD_DIM_CASES.items():
        base = serving_config(len(bits), layer_bits=bits, cap=cap)
        cfg = k1_shape_config(base, hq=hq, hkv=hkv, d=d, cap=cap,
                              layers=len(bits))
        inst, vb = fd.instance_group(hq // hkv), cfg.pruning.v_block_size
        dim = fd.instance_dim(d)
        in_smem = fd.scores_in_smem(inst, dim, cap, vb)
        check(dim == 128 and in_smem is (cap < 16384),
              f"{name}: instance <{inst}, {dim}>, plane in shared memory "
              f"{in_smem}")
        if not in_smem:
            cfg = dataclasses.replace(
                cfg,
                quant=dataclasses.replace(cfg.quant, scale_dtype="float32"),
                pruning=dataclasses.replace(cfg.pruning,
                                            importance_dtype="float32"))
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        hm = serving_head_mask(cfg, gen, dev)
        where = "shared" if in_smem else "device"
        res = {}
        for layer, b in enumerate(bits[:3]):
            r = k1_case_logged(
                errs, lines, f"{name} in <{inst}, {dim}>, {b}-bit, plane in "
                f"{where} memory", cfg, st, q, kn, vn, layer, cap, lens,
                head_mask=hm)
            t = time_k1(st, q, kn, vn, lens, cfg, [layer], cap,
                        r["threshold"], head_mask=hm)
            res[f"{b}-bit"] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                                   plain_ms=t["plain_ms"],
                                   bound_ms=t["bound_ms"],
                                   bound_by=t["bound_by"], bytes=t["bytes"])
            lines.append(f"  timing: {t['ms']:.4f} ms kernel, "
                         f"{t['plain_ms']:.4f} ms plain, bound "
                         f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                         f"{t['bytes']} B; {t['fired']} heads requantize;"
                         f" {len(lengths) * hkv} CTAs)")
        out[name] = res
        del st
        free()
    log("K1 vs plain, head dims off its instances: ok\n  "
        + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# K1 at head dims past 256 lanes, which it runs in <G, 256> as lane
# pieces: name -> (query heads, kv heads, head_dim, lengths at capacity
# 4096, batch 4), each on a 4-layer stack of 4, 6, 8 and 4 bits
WIDE_HEAD_DIM_CASES = {
    "head_dim 288, GQA 4 (16 over 4)": (16, 4, 288, [4096, 3001, 977, 1]),
    "head_dim 384, GQA 2 (4 over 2)": (4, 2, 384, [4096, 2049, 700, 64]),
    "head_dim 512, GQA 8 (8 over 1)": (8, 1, 512, [4096, 3100, 1500, 33]),
    "head_dim 1024, MHA (1 over 1)": (1, 1, 1024, [4096, 4000, 2049, 3]),
}
WIDE_HEAD_DIM_CAP = 4096


def phase_k1_wide_head_dims(dev) -> dict:
    """K1 at head dims past 256 lanes (``WIDE_HEAD_DIM_CASES``), which the
    JAX kernel takes and K1 runs in its <G, 256> instances as
    ``lane_pieces`` boxes side by side, under the serving flags at a stack
    of 4, 6, 8 and 4 bits with a serving head mask, capacity 4096, batch
    4: held against its plain version on the 4-, 6- and 8-bit layers
    (every plane byte exact), then timed on each against its bound.
    Where the plan puts the score plane in device memory the metadata is
    f32, as in ``phase_k1_head_dims``."""
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cap, bits = WIDE_HEAD_DIM_CAP, (4, 6, 8, 4)
    out, errs, lines = {}, [], []
    for name, (hq, hkv, d, lengths) in WIDE_HEAD_DIM_CASES.items():
        base = serving_config(len(bits), layer_bits=bits, cap=cap)
        cfg = k1_shape_config(base, hq=hq, hkv=hkv, d=d, cap=cap,
                              layers=len(bits))
        vb = cfg.pruning.v_block_size
        plan = fd.k1_plan(hq // hkv, d, cap, vb)
        pieces = fd.lane_pieces(d)
        check(plan.dim == 256 and pieces > 1,
              f"{name}: instance <{plan.inst}, {plan.dim}>, {pieces} pieces")
        if not plan.scores_in_smem:
            cfg = dataclasses.replace(
                cfg,
                quant=dataclasses.replace(cfg.quant, scale_dtype="float32"),
                pruning=dataclasses.replace(cfg.pruning,
                                            importance_dtype="float32"))
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        hm = serving_head_mask(cfg, gen, dev)
        where = "shared" if plan.scores_in_smem else "device"
        res = {}
        for layer, b in enumerate(bits[:3]):
            r = k1_case_logged(
                errs, lines, f"{name} in <{plan.inst}, 256> x {pieces} "
                f"pieces, {b}-bit, plane in {where} memory", cfg, st, q, kn,
                vn, layer, cap, lens, head_mask=hm)
            t = time_k1(st, q, kn, vn, lens, cfg, [layer], cap,
                        r["threshold"], head_mask=hm)
            res[f"{b}-bit"] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                                   plain_ms=t["plain_ms"],
                                   bound_ms=t["bound_ms"],
                                   bound_by=t["bound_by"], bytes=t["bytes"])
            lines.append(f"  timing: {t['ms']:.4f} ms kernel, "
                         f"{t['plain_ms']:.4f} ms plain, bound "
                         f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                         f"{t['bytes']} B; {t['fired']} heads requantize;"
                         f" {len(lengths) * hkv} CTAs)")
        out[name] = res
        del st
        free()
    log("K1 vs plain, head dims past 256 lanes: ok\n  "
        + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# K1 at the shard shapes of the mesh phases: name -> (query heads, kv
# heads, batch lengths at capacity 4096)
SHARD_SHAPE_CASES = {
    "Llama-2-7B TP-4 shard (8 over 8 kv heads of 128)": (
        8, 8, [4096, 3100, 2049, 977]),
    "Llama-2-70B TP-8 shard (8 over 1 kv head of 128)": (
        8, 1, [4096, 3100, 2049, 977]),
}


def phase_k1_shard_shapes(dev) -> dict:
    """K1 at the per-rank shapes of ``phase_sharded`` (<1, 128>, 8 kv
    heads a rank) and ``phase_sharded_70b`` (<8, 128>, 1 kv head of group
    8: 4 CTAs at batch 4, the score plane in device memory) under the
    serving flags, capacity 4096, batch 4: held against its plain version
    on one layer and timed against its bound."""
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    out, errs, lines = {}, [], []
    for name, (hq, hkv, lengths) in SHARD_SHAPE_CASES.items():
        cfg = k1_shape_config(serving_config(2), hq=hq, hkv=hkv, d=128,
                              cap=SERVING_CAP)
        plan = fd.k1_plan(hq // hkv, 128, SERVING_CAP,
                          cfg.pruning.v_block_size)
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        r = k1_case_logged(errs, lines, f"{name} in <{plan.inst}, 128>",
                           cfg, st, q, kn, vn, 0, SERVING_CAP, lens)
        t = time_k1(st, q, kn, vn, lens, cfg, [0, 1], SERVING_CAP,
                    r["threshold"])
        out[name] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], bytes=t["bytes"],
                         ctas=len(lengths) * hkv,
                         scores_in_smem=plan.scores_in_smem)
        lines.append(f"  timing: {t['ms']:.4f} ms kernel, "
                     f"{t['plain_ms']:.4f} ms plain, bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                     f"{t['bytes']} B; {t['fired']} heads requantize; "
                     f"{len(lengths) * hkv} CTAs)")
        del st
        free()
    log("K1 vs plain, mesh shard shapes: ok\n  " + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# Llama-2-70B's TP-4 shard (16 query heads over 2 kv heads of 128 a card,
# K1's <8, 128, false>), batch 4: rung -> lengths
ROUNDING_CASES = {4096: [4096, 3100, 2049, 977], 2048: [2048, 1601, 977, 33]}


def phase_k1_rounding(dev) -> dict:
    """K1 against its plain version stage by stage, bit for bit
    (``kernel_checks.k1_stages``), at Llama-2-70B's TP-4 shard instance
    under the serving flags, one layer at each rung: every stage must be
    exact."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    cfg = k1_shape_config(serving_config(2), hq=16, hkv=2, d=128,
                          cap=SERVING_CAP)
    vb = cfg.pruning.v_block_size
    out, lines = {}, []
    for rung, lengths in ROUNDING_CASES.items():
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        kw = k1_flags(cfg, 0, rung)
        probe = st.clone()
        mp = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lens, layer=0,
            v_block_size=vb, importance_in=probe.importance, **kw)[1].max_prob
        del probe
        rep = kc.k1_stages(st, q, kn, vn, lens, layer=0,
                           threshold=kc.split_threshold(mp), v_block=vb,
                           keep_blocks=fd._v_keep_blocks(kw["v_keep"], vb,
                                                         rung, 0), **kw)
        out[rung] = rep
        inexact = [k for k, v in rep.items()
                   if (v["flips"] if "flips" in v
                       else v["exact"] != v["total"])]
        check(not inexact, f"K1 vs plain at rung {rung}: stages {inexact} "
              "are not bit-equal")
        lines.append(f"rung {rung}: " + "; ".join(
            f"{k} {v['flips']} of {v['total']} flipped" if k == "keep"
            else f"{k} {v['exact']}/{v['total']} exact (max {v['max_ulp']}"
                 f" ulp, {v['max_abs']:.2e})"
            for k, v in rep.items()))
        del st
        free()
    log("K1 vs plain stage by stage, Llama-2-70B TP-4 shard <8, 128, "
        "false>, serving flags:\n  " + "\n  ".join(lines))
    return out


SKIP_APPEND_CASES = {2048: [2048, 1900, 1601, 1200, 977, 800, 729, 33],
                     4096: [4096, 3200, 3100, 2665, 2800, 2049, 1000, 1]}


def phase_k1_skip_append(dev) -> dict:
    """K1's ``_skip_append`` at the serving shapes (Llama-2-7B's 32 kv
    heads of 128 in ``<1, 128>``, batch 8, the serving flags; one layer
    at each rung): every stage bit-equal to its plain version
    (``kernel_checks.k1_stages``, whose V-block keep stage reads every
    row, so without a head mask); then under a 24-of-32 head mask no byte
    of the int8 or nibble planes written (each byte-identical before and
    after a call), the scales, importance and output as the appending
    step gives them; K1's time with and without the append."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    cfg = serving_config(2)
    vb = cfg.pruning.v_block_size
    hm = serving_head_mask(cfg, gen, dev)
    out, lines = {}, []
    for rung, lengths in SKIP_APPEND_CASES.items():
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        flags = k1_flags(cfg, 0, rung)
        probe = st.clone()
        mp = fd.fused_decode_attention_plain(
            q, probe.cache.k, probe.cache.v, kn, vn, lens, layer=0,
            v_block_size=vb, importance_in=probe.importance,
            **flags)[1].max_prob
        del probe
        thr = kc.split_threshold(mp)
        rep = kc.k1_stages(st, q, kn, vn, lens, layer=0, threshold=thr,
                           v_block=vb, keep_blocks=fd._v_keep_blocks(
                               flags["v_keep"], vb, rung, 0),
                           _skip_append=True, **flags)
        inexact = [k for k, v in rep.items()
                   if (v["flips"] if "flips" in v
                       else v["exact"] != v["total"])]
        check(not inexact, f"K1 _skip_append vs plain at rung {rung}: "
              f"stages {inexact} are not bit-equal")

        def call(state, skip, layer=0):
            return fd.fused_decode_attention(
                q, state.cache.k, state.cache.v, kn, vn, lens,
                requant_threshold=thr, importance_in=state.importance,
                layer=layer, v_block_size=vb, head_mask=hm,
                _skip_append=skip, **flags)

        skipped, appended = st.clone(), st.clone()
        res_s, res_a = call(skipped, True), call(appended, False)
        torch.cuda.synchronize()
        for name in ("full", "msb"):
            check(torch.equal(getattr(skipped.cache.k, name),
                              getattr(st.cache.k, name)),
                  f"K1 _skip_append wrote the K {name} plane")
        check(torch.equal(skipped.cache.v.full, st.cache.v.full),
              "K1 _skip_append wrote the V plane")
        for kv in ("k", "v"):
            check(torch.equal(getattr(skipped.cache, kv).scale,
                              getattr(appended.cache, kv).scale),
                  f"K1 _skip_append's {kv} scales differ from the "
                  "appending step's")
        check(torch.equal(res_s[0], res_a[0])
              and torch.equal(skipped.importance, appended.importance),
              "K1 _skip_append's outputs differ from the appending step's")
        del skipped, appended, res_s, res_a
        ms_app = device_ms(lambda i: call(st, False, i % 2), 16)
        ms_skip = device_ms(lambda i: call(st, True, i % 2), 16)
        out[rung] = dict(ms=ms_skip, ms_append=ms_app, stages={
            k: f"{v['exact']}/{v['total']}" for k, v in rep.items()
            if "exact" in v})
        lines.append(f"rung {rung}: every stage bit-equal ("
                     + "; ".join(f"{k} {v}" for k, v in
                                 out[rung]["stages"].items())
                     + f"); head-masked: planes untouched, scales, "
                     f"importance and output as appended; K1 "
                     f"{ms_app:.4f} ms with the append, {ms_skip:.4f} ms "
                     "with _skip_append")
        del st
        free()
    log("K1 _skip_append vs plain, serving shapes [2, 8, 4096, 4096], "
        "<1, 128>:\n  " + "\n  ".join(lines))
    return out


# K1 at stored capacities and rungs off a multiple of 8, Llama-2-7B's
# attention (32 kv heads of 128), batch 8: name -> (capacity, rung,
# v_block, bf16 metadata, layer bits, lengths)
CAPACITY_CASES = {
    "capacity 1020, v_block 4, bf16 planes": (
        1020, 1020, 4, True, (4, 4),
        [1020, 1019, 1013, 900, 700, 509, 33, 2]),
    "capacity 1020, v_block 4, f32 planes": (
        1020, 1020, 4, False, (4, 4),
        [1020, 1016, 1013, 900, 700, 509, 33, 2]),
    "capacity 3000 at rung 1500, v_block 60, 6-bit": (
        3000, 1500, 60, True, (6, 6),
        [1500, 1499, 1494, 1200, 751, 750, 33, 3]),
}


# DeepSeek-V2-Lite's attention as the port caches it: one latent row of
# 512 + 64 lanes read by 16 query heads, at the cell's batch and capacity
LATENT_BATCH, LATENT_CAP = 128, 2048


def latent_config(layers: int = 2, batch: int = LATENT_BATCH):
    """``portbench``'s ``deepseek-v2-lite`` configuration (the cell's
    widths and serving knobs) at ``layers`` layers and ``batch`` rows."""
    import json
    from portbench import manifest
    c = json.loads((Path(__file__).resolve().parent / "portbench" /
                    "configs" / "deepseek-v2-lite.json").read_text())
    c["num_hidden_layers"] = layers
    c["engine"]["max_batch_size"] = batch
    return manifest.path(c).program_config(c)


def latent_plan(cfg, rung: int):
    """K1's plan for the latent cache of ``cfg`` at ``rung`` under the
    flags ``run_layers`` passes it (per-row importance in delta mode)."""
    from spatten_tpu_torch.ops import fused_decode as fd
    m, q = cfg.model, cfg.quant
    latent = fd.latent_takes(
        m.cache_heads, cfg.engine.cache_capacity, quant_enabled=q.enabled,
        has_lsb2=q.needs_lsb2,
        quantize_queries=q.quantize_queries, pv_int8=q.pv_int8,
        importance_kind=cfg.pruning.importance_kind, delta_rows=True)
    return fd.k1_plan(m.num_heads // m.cache_heads, m.cache_dim, rung,
                      cfg.pruning.v_block_size, latent=latent)


def latent_k1_case(cfg, st, q, row, lengths, rung, hm, layer=0,
                   instance="latent", **extra) -> dict:
    """``k1_case`` on the latent cache as ``run_layers`` calls K1 for it,
    with a check that the call ran in ``instance`` (the latent one, or
    the <G, D> one it takes otherwise)."""
    from spatten_tpu_torch.ops import fused_decode as fd
    before = fd.fused_decode_attention.latent_launches
    r = k1_case(st, q, row, row, lengths, cfg, layer, rung, head_mask=hm,
                delta_mode=True, per_row_importance=True,
                sm_scale=cfg.model.softmax_scale, **extra)
    took = fd.fused_decode_attention.latent_launches - before
    check(took == (instance == "latent"),
          f"latent K1 case ran {took} latent launches, not in {instance}")
    return r


def phase_k1_latent(dev) -> dict:
    """K1 at the latent shape (batch 128, one kv head of 576 lanes, group
    16, the cell's serving flags, per-row importance in delta mode as
    ``run_layers`` calls it for a latent cache, a partly masked group),
    in K1's latent instance: at the cell's capacity 2048 (whose one rung
    is 2048: the pack unit spans it; the score plane in shared memory)
    and at capacity 4096 in both its rungs (4096, with the plane in
    device memory, and 2048, as a longer cell's layers would run), each
    held against its plain version, then timed beside the bytes the
    latent needs (``portbench/counts_deepseek_v2.k1_bytes``); at 2048 the
    plain version's time too.  Then the instance's other paths at
    capacity 2048, each held against its plain version: a 4/6/8-bit
    layer profile (tiles of 32 packed rows beside their 2-bit rows, the
    6-bit pass 1, an 8-bit pass 1) and f32 scales; and one call with row
    stats, which the latent instance does not take: it must run in
    <8, 256> and pass too."""
    from portbench import counts_deepseek_v2 as dcounts
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd
    out, lines = {}, []
    for cap, rung in ((LATENT_CAP, LATENT_CAP), (2 * LATENT_CAP,
                                                2 * LATENT_CAP),
                      (2 * LATENT_CAP, LATENT_CAP)):
        cfg = latent_config()
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, cache_capacity=cap))
        m, vb = cfg.model, cfg.pruning.v_block_size
        w, hq = m.cache_dim, m.num_heads
        plan = latent_plan(cfg, rung)
        check(plan.latent and plan.inst == 16 and plan.rows == 16
              and plan.scores_in_smem == (rung == LATENT_CAP),
              f"latent plan {plan}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 19)
        st = kc.random_state(cfg, LATENT_BATCH, gen, dev)
        q = torch.randn((LATENT_BATCH, hq, 1, w), generator=gen, device=dev)
        row = torch.randn((LATENT_BATCH, 1, 1, w), generator=gen,
                          device=dev)
        hm = torch.ones(hq, dtype=torch.bool, device=dev)
        hm[[1, 6, 11, 12]] = False                 # the serving 12 of 16
        lengths = torch.randint(1, rung + 1, (LATENT_BATCH,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = rung, 1
        r = latent_k1_case(cfg, st, q, row, lengths, rung, hm)
        kw = dict(r["kw"], layer=0, requant_threshold=r["threshold"],
                  v_block_size=vb, head_mask=hm, per_row_importance=True)

        def call(fn, i):
            return fn(q, st.cache.k, st.cache.v, row, row, lengths,
                      importance_in=None, **dict(kw, layer=i % 2))
        ms = device_ms(lambda i: call(fd.fused_decode_attention, i), 8)
        plain_ms = (device_ms(lambda i: call(
            fd.fused_decode_attention_plain, i), 2)
            if cap == rung == LATENT_CAP else None)
        stats = call(fd.fused_decode_attention, 0)[1]
        kb = fd._v_keep_blocks(kw["v_keep"], vb, rung, 0)
        n = lengths.tolist()
        fired = [bool(x) for x in stats.need_requant[:, 0].tolist()]
        kept = [min(kb * vb, x) if kb else x for x in n]
        live = int(hm.sum())
        byts = dcounts.k1_bytes(
            n, [[live > 0]] * len(n), [[f] for f in fired],
            [[k] for k in kept], kv_heads=1, group=hq, head_dim=w,
            capacity=cap, rung=rung, scale_bytes=2, imp_bytes=2,
            rope=m.qk_rope_head_dim, live_heads=[[live]] * len(n))
        bound = byts / 3.35e12 * 1e3
        where = "shared" if plan.scores_in_smem else "device"
        lines.append(f"K1 latent capacity {cap} rung {rung} (latent "
                     f"instance, score plane in {where} memory): vs plain "
                     f"max |out err| {r['max_abs_err']:.2e} (fires "
                     f"{r['fired']}, out bit-equal {r['out_exact']}/"
                     f"{r['out_total']}); {ms:.4f} ms, bound {bound:.4f} ms "
                     f"({byts} B, {100 * bound / ms:.2f}% of roofline)"
                     + ("" if plain_ms is None
                        else f"; plain {plain_ms:.4f} ms"))
        out[f"{cap}/{rung}"] = dict(max_abs_err=r["max_abs_err"], ms=ms,
                                    bound_ms=bound, bytes=byts,
                                    fired=r["fired"], plain_ms=plain_ms,
                                    out_exact=r["out_exact"],
                                    out_total=r["out_total"])
        del st
        free()
    # the instance's other paths: a 4/6/8-bit profile over 3 layers, and
    # f32 scales
    bits = (4, 6, 8)
    base = latent_config(len(bits))
    for name, cfg in (
            ("4/6/8-bit profile", dataclasses.replace(
                base, quant=dataclasses.replace(base.quant,
                                                layer_bits=bits))),
            ("f32 scales", dataclasses.replace(
                base, quant=dataclasses.replace(base.quant,
                                                scale_dtype="float32")))):
        m = cfg.model
        plan = latent_plan(cfg, LATENT_CAP)
        check(plan.latent, f"latent plan, {name}: {plan}")
        gen = torch.Generator(device=dev).manual_seed(SEED + 37)
        st = kc.random_state(cfg, LATENT_BATCH, gen, dev)
        q = torch.randn((LATENT_BATCH, m.num_heads, 1, m.cache_dim),
                        generator=gen, device=dev)
        row = torch.randn((LATENT_BATCH, 1, 1, m.cache_dim), generator=gen,
                          device=dev)
        lengths = torch.randint(1, LATENT_CAP + 1, (LATENT_BATCH,),
                                generator=gen, device=dev, dtype=torch.int32)
        lengths[0], lengths[1] = LATENT_CAP, 1
        layers = range(len(bits)) if cfg.quant.layer_bits else (0,)
        for layer in layers:
            r = latent_k1_case(cfg, st, q, row, lengths, LATENT_CAP, hm,
                               layer=layer)
            what = (f"{bits[layer]}-bit layer" if cfg.quant.layer_bits
                    else "4-bit")
            lines.append(f"K1 latent, {name}, {what}: vs plain max |out "
                         f"err| {r['max_abs_err']:.2e} (fires {r['fired']}, "
                         f"out bit-equal {r['out_exact']}/"
                         f"{r['out_total']})")
            out[f"{name}/{layer}"] = dict(max_abs_err=r["max_abs_err"],
                                          fired=r["fired"])
        del st
        free()
    # row stats are not the latent instance's: the old instance runs
    cfg = latent_config()
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    st = kc.random_state(cfg, LATENT_BATCH, gen, dev)
    q = torch.randn((LATENT_BATCH, 16, 1, cfg.model.cache_dim),
                    generator=gen, device=dev)
    row = torch.randn((LATENT_BATCH, 1, 1, cfg.model.cache_dim),
                      generator=gen, device=dev)
    lengths = torch.randint(1, LATENT_CAP + 1, (LATENT_BATCH,),
                            generator=gen, device=dev, dtype=torch.int32)
    r = latent_k1_case(cfg, st, q, row, lengths, LATENT_CAP, hm,
                       instance="<8, 256>", return_row_stats=True)
    lines.append(f"K1 latent with row stats (in <8, 256>): vs plain max "
                 f"|out err| {r['max_abs_err']:.2e}")
    out["row stats"] = dict(max_abs_err=r["max_abs_err"])
    del st
    free()
    for line in lines:
        log(line)
    return out


def phase_grouped_gemm(dev) -> dict:
    """DeepSeek-V2-Lite's expert layer on the card: ``torch._grouped_mm``
    in bf16 (the routed dispatch of ``models/moe.experts``) against the
    plain loop over experts, at a decode step's and an admission chunk's
    128 tokens (768 picks over 64 experts of 1408) and at 5 tokens
    (most experts get none), then inside a captured CUDA graph (bit-equal
    to eager), then timed beside the bytes it needs
    (``counts_deepseek_v2.moe_bytes``); the device kernels' names."""
    from portbench import counts_deepseek_v2 as dcounts
    from spatten_tpu_torch.models import moe
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    d, inter, n_exp, k = 2048, 1408, 64, 6
    bf = torch.bfloat16
    wgu = (torch.randn((n_exp, 2 * inter, d), generator=gen, device=dev)
           / math.sqrt(d)).to(bf)
    wd = (torch.randn((n_exp, d, inter), generator=gen, device=dev)
          / math.sqrt(inter)).to(bf)
    router = (torch.randn((d, n_exp), generator=gen, device=dev)
              / math.sqrt(d)).to(bf)
    res = {"torch": torch.__version__}
    for t in (128, 5):
        h = torch.randn((t, d), generator=gen, device=dev).to(bf)
        wts, idx = moe.route(h, router, k)
        got, offs = moe.experts(h, wgu, wd, wts, idx)
        want = moe.experts_loop(h, wgu, wd, wts, idx)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        hits = moe.counts(offs)
        check(int(hits.sum()) == t * k, "grouped offsets lose rows")
        check(err <= 2e-2 * scale, f"grouped GEMM vs loop: {err} of {scale}")
        res[f"tokens_{t}"] = dict(max_abs_err=err, max_abs=scale,
                                  idle_experts=int((hits == 0).sum()))
        log(f"grouped GEMM, {t} tokens: max |err| {err:.3e} of {scale:.3e}"
            f", {int((hits == 0).sum())} experts idle")
    h = torch.randn((128, d), generator=gen, device=dev).to(bf)
    wts, idx = moe.route(h, router, k)
    eager, _ = moe.experts(h, wgu, wd, wts, idx)
    hs, ws, ids = h.clone(), wts.clone(), idx.clone()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        moe.experts(hs, wgu, wd, ws, ids)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g_out, g_offs = moe.experts(hs, wgu, wd, ws, ids)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(g_out, eager), "grouped GEMM graph replay != eager")
    ms = device_ms(lambda i: moe.experts(h, wgu, wd, wts, idx), 20)
    byts = dcounts.moe_bytes(moe.counts(g_offs).tolist(), d, inter)
    bound = byts / 3.35e12 * 1e3
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        moe.experts(h, wgu, wd, wts, idx)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    res.update(graph_equal=True, ms=ms, bound_ms=bound, bytes=byts,
               kernels=names)
    log(f"grouped GEMM 128 tokens: {ms:.4f} ms, bound {bound:.4f} ms "
        f"({byts} B, {100 * bound / ms:.1f}% of roofline); kernels {names}")
    return res


# (prompt tokens, budget) of phase_server_latent's requests: full-length
# admission chunks (from the prefill graph), ragged ones and short ones
LATENT_SERVER_REQUESTS = ((384, 12), (130, 20), (40, 8), (700, 6),
                          (256, 16), (17, 24), (513, 10), (128, 14),
                          (90, 18), (1000, 5), (3, 9), (300, 11))


def phase_server_latent(dev) -> dict:
    """``SpAttenServer`` at DeepSeek-V2-Lite's widths on 2 layers
    (``latent_config(2, 8)``: layer 0 dense, layer 1 with its 64 experts;
    random bf16 weights; 8 slots): ``LATENT_SERVER_REQUESTS`` run to
    completion with K1's launch count set to 0 just before and read just
    after.  Every request must finish with exactly its budget and every
    slot end free; K1 must launch once per layer and single-token call
    (each decode tick, and the one-token last chunk of the 513-token
    prompt's admission): the latent row through the kernel on every
    layer, no plain version, every launch in K1's latent instance
    (``latent_launches``, and the tracer's ``k1.launch`` spans, on for the
    run, each noting ``instance="latent"``); the full-length admission
    chunks replay from the prefill graph."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.server import SpAttenServer
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.utils.profiling import tracer
    cfg = latent_config(2, 8)
    m = cfg.model
    check(tr.decode_uses_kernel(cfg, "cuda"),
          "latent server: the gate sends decode to the plain version")
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng(SEED + 29)
    srv = SpAttenServer(params, cfg, device=dev)
    budget = {srv.submit(rng.integers(0, m.vocab_size, n), new): new
              for n, new in LATENT_SERVER_REQUESTS}
    run_decode_step, run_prefill_chunk = gen.decode_step, gen.prefill_chunk
    ticks = singles = 0

    def decode_step(*args, **kw):
        nonlocal ticks
        ticks += 1
        return run_decode_step(*args, **kw)

    def prefill_chunk(p, c, state, ids, **kw):
        nonlocal singles
        singles += ids.shape[1] == 1
        return run_prefill_chunk(p, c, state, ids, **kw)

    fused_decode_attention.launches = 0
    fused_decode_attention.latent_launches = 0
    gen.decode_step, gen.prefill_chunk = decode_step, prefill_chunk
    tracer.drain()
    tracer.enable()
    t0 = time.perf_counter()
    try:
        done = srv.run_to_completion()
    finally:
        tracer.disable()
        gen.decode_step = run_decode_step
        gen.prefill_chunk = run_prefill_chunk
    wall = time.perf_counter() - t0
    k1 = fused_decode_attention.launches
    latent = fused_decode_attention.latent_launches
    noted = [sp.attrs.get("instance") for sp in tracer.drain()
             if sp.name == "k1.launch"]
    graphed = srv.prefill_graph.replays
    check(sorted(r.request_id for r in done) == sorted(budget),
          "latent server: not every request finished")
    check(all(len(r.generated) == budget[r.request_id] for r in done),
          "latent server: a request did not emit exactly its budget")
    check(sorted(srv.free_slots) == list(range(srv.batch)),
          f"latent server: slots {srv.free_slots} are not all free")
    check(ticks > 0 and singles > 0
          and k1 == m.num_layers * (ticks + singles),
          f"latent server: K1 launched {k1} times for {ticks} decode ticks "
          f"and {singles} one-token chunks of {m.num_layers} layers")
    check(latent == k1 and noted == ["latent"] * k1,
          f"latent server: {latent} of {k1} K1 launches in the latent "
          f"instance; k1.launch spans note {sorted(set(map(str, noted)))}")
    check(graphed >= 1, "latent server: no admission chunk from the graph")
    log(f"latent server (DeepSeek-V2-Lite widths, {m.num_layers} layers, "
        f"{srv.batch} slots): {len(done)} requests in {ticks} decode "
        f"ticks, {wall:.2f} s; K1 launches {k1} (= {m.num_layers} x "
        f"({ticks} decode ticks + {singles} one-token chunks), none in the "
        f"plain version, all {latent} in the latent instance, each "
        f"k1.launch span noting it); prefill chunks from the graph "
        f"{graphed}")
    del params, srv
    free()
    return dict(k1=k1, latent=latent, ticks=ticks, single_chunks=singles,
                layers=m.num_layers, wall_s=wall, graphed=graphed)


def phase_k1_capacity(dev) -> dict:
    """K1 at stored capacities and rungs off a multiple of 8
    (``CAPACITY_CASES``): 1020 tokens at v_block 4 (pack unit 1020, a
    half-unit of 510 rows) with bf16 and with f32 scale and importance
    planes, and 3000 tokens at the rung 1500 (pack unit 1500; a 6-bit
    layer, whose 2-bit plane has quarter-units of 375 rows), under the
    serving flags with a serving head mask, appending in the last slots
    of the plane and of its units; each held against its plain version,
    then timed (Llama-2-7B's attention, batch 8, depth 2)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    out, errs, lines = {}, [], []
    for name, (cap, rung, vb, bf16, bits, lengths) in CAPACITY_CASES.items():
        base = serving_config(2, layer_bits=bits if 6 in bits else None)
        dt = "bfloat16" if bf16 else "float32"
        cfg = dataclasses.replace(
            base,
            engine=dataclasses.replace(base.engine, cache_capacity=cap),
            quant=dataclasses.replace(base.quant, scale_dtype=dt),
            pruning=dataclasses.replace(
                base.pruning, v_block_size=vb, importance_dtype=dt,
                start_size=4, important_size=int(rung * 0.55),
                recent_size=int(rung * 0.10))).validate()
        st, q, kn, vn = k1_inputs(cfg, dev, gen, len(lengths))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        hm = serving_head_mask(cfg, gen, dev)
        r = k1_case_logged(errs, lines, name, cfg, st, q, kn, vn, 1, rung,
                           lens, head_mask=hm)
        t = time_k1(st, q, kn, vn, lens, cfg, [0, 1], rung, r["threshold"],
                    head_mask=hm)
        lines.append(f"  timing: {t['ms']:.4f} ms kernel, "
                     f"{t['plain_ms']:.4f} ms plain, bound "
                     f"{t['bound_ms']:.4f} ms ({t['bound_by']}: "
                     f"{t['bytes']} B; {t['fired']} heads requantize)")
        out[name] = dict(max_abs_err=r["max_abs_err"], ms=t["ms"],
                         plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                         bound_by=t["bound_by"], bytes=t["bytes"])
        del st
        free()
    log("K1 vs plain, capacities off a multiple of 8: ok\n  "
        + "\n  ".join(lines))
    return dict(max_abs_err=max(errs), cases=out)


# phase_server: 12 requests submitted at once to an arena of 8 slots, so
# that four wait for recycled slots; prompts and budgets cycle
SERVER_PROMPTS, SERVER_BUDGETS, SERVER_REQUESTS = (
    (1024, 1536, 2048, 3072), (16, 32, 48, 64), 12)
SERVER_PROFILE_TICKS = range(20, 28)


def _device_ms(prof) -> float:
    """Device time (ms) in a torch.profiler trace: device-side events
    only, as ``profile_decode`` sums them."""
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA) / 1e3


def phase_server(dev) -> dict:
    """``SpAttenServer`` at Llama-2-7B width and depth under
    ``serving_config()`` (random bf16 weights, ``max_batch_size`` 8,
    capacity 4096): ``SERVER_REQUESTS`` requests submitted at once, with
    prompts cycling over ``SERVER_PROMPTS`` tokens and budgets over
    ``SERVER_BUDGETS``, run to completion with the launch counts set to 0
    just before and read just after.  Every request must finish with
    exactly its budget and every slot end free; K1 must launch 32 times per
    decode tick and K2 at least once (the admissions' prefills prune the
    rung-2048 layers).  The first decode tick after each wave of requests
    joins the arena is rerun from a copy of its state through the plain
    versions (``plain_versions``), fed the same tokens, and the active
    slots' logits held to ``window_vs_plain``'s
    bf16 rule.  Ticks ``SERVER_PROFILE_TICKS`` are profiled for their
    device time; the host clock of the other ticks gives ms per tick."""
    from torch.profiler import ProfilerActivity, profile
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.server import SpAttenServer
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    cfg = serving_config()
    m = cfg.model
    t0 = time.perf_counter()
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    log(f"server: params {m.num_layers} layers, bf16, in "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED + 11)
    requests = [(rng.integers(0, m.vocab_size,
                              SERVER_PROMPTS[i % len(SERVER_PROMPTS)]),
                 SERVER_BUDGETS[i % len(SERVER_BUDGETS)])
                for i in range(SERVER_REQUESTS)]
    srv = SpAttenServer(params, cfg, device=dev)
    budget = {srv.submit(p, n): n for p, n in requests}
    run_decode_step = gen.decode_step
    seen, checks, tick_ms, prof_ms = set(), [], [], []
    check_s = 0.0

    def tick(state, token):
        # gen.decode_step's body, returning the logits
        state, _ = gen.maybe_prune(cfg, state, 1)
        state = gen.maybe_update_head_mask(cfg, state)
        logits, state, aux = tr.forward(params, cfg, state, token[:, None])
        return logits[:, -1], state, aux

    def decode_step(p, c, state, token):
        nonlocal check_s
        n = len(tick_ms) + len(prof_ms)
        ids = {r.request_id for r in srv.active.values()}
        slots = sorted(srv.active)
        joined = ids - seen
        seen.update(ids)
        plain = None
        if joined:
            t = time.perf_counter()
            snap = state.clone()
            with plain_versions():
                plain = tick(snap, token)[0][slots].float()
            del snap
            torch.cuda.synchronize()
            check_s += time.perf_counter() - t
        prof = None
        if n in SERVER_PROFILE_TICKS:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits, state, aux = tick(state, token)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        if prof is not None:
            prof.__exit__(None, None, None)
            prof_ms.append(_device_ms(prof))
        else:
            tick_ms.append(ms)
        if plain is not None:
            lk = logits[slots].float()
            check(bool(torch.isfinite(lk).all()), "server: non-finite logits")
            diff = (lk - plain).abs()
            checks.append(dict(tick=n, joined=len(joined), rows=len(slots),
                               mean=float(diff.mean()),
                               max=float(diff.max()),
                               agree=int((lk.argmax(-1) == plain.argmax(-1))
                                         .sum())))
        return nxt, state, aux

    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    gen.decode_step = decode_step
    t0 = time.perf_counter()
    try:
        done = srv.run_to_completion()
    finally:
        gen.decode_step = run_decode_step
    wall = time.perf_counter() - t0 - check_s
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    ticks = len(tick_ms) + len(prof_ms)
    check(sorted(r.request_id for r in done) == sorted(budget),
          "server: not every request finished")
    check(all(len(r.generated) == budget[r.request_id] for r in done),
          "server: a request did not emit exactly its budget")
    check(sorted(srv.free_slots) == list(range(srv.batch)),
          f"server: slots {srv.free_slots} are not all free")
    check(k1 == m.num_layers * ticks, f"server: K1 launched {k1} times for "
          f"{ticks} decode ticks")
    check(k2 >= 1, "server: K2 never launched")
    rows = sum(c["rows"] for c in checks)
    mean = sum(c["mean"] * c["rows"] for c in checks) / rows
    agree = sum(c["agree"] for c in checks) / rows
    log(f"server: {len(done)} requests (prompts {SERVER_PROMPTS} tokens, "
        f"budgets {SERVER_BUDGETS}) through {srv.batch} slots in {ticks} "
        f"decode ticks, {wall:.2f} s (the plain reruns' {check_s:.2f} s "
        f"taken out): {ticks / wall:.2f} ticks/s, "
        f"{sum(budget.values()) / wall:.1f} generated tok/s; completion "
        f"order {[r.request_id for r in done]}; K1 launches {k1} "
        f"(= {m.num_layers} x {ticks}), K2 launches {k2}; prefill chunks "
        f"from the graph {srv.prefill_graph.replays}")
    step_ms = float(np.median(tick_ms))
    dev_ms = float(np.median(prof_ms))
    log(f"server: decode tick host clock median {step_ms:.2f} ms (mean "
        f"{float(np.mean(tick_ms)):.2f}, {len(tick_ms)} ticks); device "
        f"{dev_ms:.3f} ms per tick (median of ticks "
        f"{SERVER_PROFILE_TICKS.start}-{SERVER_PROFILE_TICKS.stop - 1}, "
        f"profiled) -> idle {1 - dev_ms / step_ms:.3f}")
    log("server: first decode tick of each joining wave, kernels vs plain "
        f"on the card (same tokens): {[(c['tick'], c['joined'], c['rows'], round(c['mean'], 4), round(c['max'], 3), c['agree']) for c in checks]} "
        f"(tick, joined, active rows, mean |logit diff|, max, argmax "
        f"agreements); pooled mean {mean:.2e} (tolerance {WINDOW_MEAN_TOL}),"
        f" argmax agreement {agree:.3f} (min {WINDOW_ARGMAX_MIN})")
    check(mean <= WINDOW_MEAN_TOL and all(
        c["mean"] <= WINDOW_MEAN_TOL for c in checks),
        f"server: mean logit error {mean}")
    check(agree >= WINDOW_ARGMAX_MIN, f"server: argmax agreement {agree}")
    srv_graphed = srv.prefill_graph.replays
    del params, srv
    free()
    return dict(k1=k1, k2=k2, ticks=ticks, wall_s=wall,
                graphed=srv_graphed,
                tok_s=sum(budget.values()) / wall, step_ms=step_ms,
                device_ms=dev_ms, idle=1 - dev_ms / step_ms)


def server_small_check(dev) -> dict:
    """A small f32 server run on the card: ``device_scores_configs()``'s
    GQA-8 model (8 query heads over 1 kv head of 128, capacity 4096; K1
    with its score plane in device memory) with ``max_batch_size`` 2, six
    requests, each forward call held against its replay on the CPU
    (``kernel_checks.check_server_against_cpu``: the single-token calls'
    logits within 1e-3, tokens equal where the top-2 margin is clear in
    every call, budgets met, slots free, K1 once per layer and
    single-token call)."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.models import transformer as tr
    [(cfg, _, _, _)] = device_scores_configs().values()
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, max_batch_size=2)).validate()
    params = tr.init_params(cfg.model, SEED, dtype=torch.float32,
                            device="cpu")
    rng = np.random.default_rng(SEED + 12)
    requests = [(rng.integers(0, cfg.model.vocab_size, n), new)
                for n, new in ((300, 12), (2040, 8), (77, 16), (1100, 6),
                               (513, 10), (40, 4))]
    r = kc.check_server_against_cpu(cfg, params, requests, dev)
    log(f"server, small f32 (GQA 8 x 128, capacity 4096, 2 slots, 6 "
        f"requests) on the card vs its CPU replay: {r['calls']} calls "
        f"({r['graphed']} prefill chunks from the graph), "
        f"{r['ticks']} decode ticks, single-token calls' logits max |diff| "
        f"{r['max_logit_err']:.2e} (tolerance {kc.CPU_REPLAY_LOGIT_TOL}), "
        f"prefill chunks' {r['prefill_logit_err']:.2e} (reported); "
        f"tokens equal where the top-2 margin is clear "
        f"({r['clear_share']:.3f} of rows); K1 launches {r['k1']}, K2 "
        f"{r['k2']}; completion order {r['order']}; worst calls (err, "
        f"call, tokens) {r['worst_calls']}")
    free()
    return r


TRACE_STEPS = 16


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def phase_trace(dev) -> dict:
    """``engine.trace.collect_trace`` on ``profile_config()`` (depth 8,
    the 4,4,6,6,8 profile, batch 8, prompt 3072) for ``TRACE_STEPS``
    decode steps on the card; the CSV goes to ``build/trace_profile.csv``
    (and reads back equal), is priced with ``perf.cost_model`` at the
    card preset (``H100_SXM``, with this model's bf16 weight bytes per
    step) against its dense fp16 bytes, and the ``key_fetch_num`` decay
    by layer is printed."""
    from pathlib import Path
    from spatten_tpu_torch.engine import trace as trc
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.perf import cost_model as cm
    cfg = profile_config(8)
    m = cfg.model
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    prompt = np.random.default_rng(SEED).integers(
        0, m.vocab_size, (SERVING_BATCH, SERVING_PROMPT))
    fused_decode_attention.launches = 0
    t0 = time.perf_counter()
    rows = trc.collect_trace(params, cfg, prompt, TRACE_STEPS, device=dev)
    secs = time.perf_counter() - t0
    k1 = fused_decode_attention.launches
    check(k1 == m.num_layers * TRACE_STEPS, f"trace: K1 launched {k1}")
    path = Path(__file__).resolve().parent / "build" / "trace_profile.csv"
    path.parent.mkdir(parents=True, exist_ok=True)
    trc.write_csv(rows, str(path))
    check(trc.read_csv(str(path)) == rows, "trace: CSV round trip")
    check(len({r.layer_id for r in rows}) == m.num_layers
          and len({r.iteration_id for r in rows}) == TRACE_STEPS,
          "trace: rows miss a layer or a step")
    # the bytes a decode step streams: every layer's weights, the final
    # norm and the LM head (the tied embedding where there is none)
    streamed = [params["layers"], params["final_norm_w"],
                params.get("lm_head", params["embed"])]
    weights = sum(t.numel() * t.element_size() for t in _leaves(streamed))
    hw = dataclasses.replace(cm.H100_SXM, weight_bytes_per_step=weights)
    cost = cm.estimate_cost(rows, hw)
    dense = cm.dense_bytes(rows)
    by_layer = {}
    for r in rows:
        if r.iteration_id == TRACE_STEPS - 1:
            by_layer.setdefault(r.layer_id, set()).add(r.key_fetch_num)
    requant = sum(r.if_requant for r in rows) / len(rows)
    log(f"trace: {len(rows)} rows ({TRACE_STEPS} steps x {m.num_layers} "
        f"layers x alive kv heads) in {secs:.2f} s, K1 launches {k1}; CSV "
        f"{path.relative_to(path.parent.parent)}; key_fetch_num by layer at "
        f"the last step {[sorted(v) for _, v in sorted(by_layer.items())]}; "
        f"requant share {requant:.3f}; cost model at the card preset "
        f"({hw.hbm_gbps} GB/s, {hw.peak_tflops} TFLOP/s, step overhead "
        f"{hw.step_overhead_us} us, weights {weights / 1e9:.3f} GB/step): "
        f"{cost.total_bytes / 1e9:.3f} GB over {cost.iterations} steps, "
        f"{cost.total_seconds * 1e3:.3f} ms, {cost.tokens_per_s:.1f} steps/s;"
        f" attention bytes vs dense fp16 "
        f"{(cost.total_bytes - weights * cost.iterations) / dense:.4f} "
        f"(native library: {cm._load_lib() is not None})")
    del params
    free()
    return dict(rows=len(rows), k1=k1, cost=dataclasses.asdict(cost),
                dense_bytes=dense, csv=str(path), weight_bytes=weights)


def phase_replay(dev, trace: dict) -> dict:
    """``phase_trace``'s CSV through ``tools/replay_trace.py`` at the card
    preset with the trace's weight bytes per step: its JSON, whose
    modeled seconds must equal ``estimate_cost``'s in ``phase_trace``."""
    from spatten_tpu_torch.tools import replay_trace
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        replay_trace.main([trace["csv"], "--weight-bytes-per-step",
                           repr(float(trace["weight_bytes"]))])
    res = json.loads(out.getvalue())
    check(res["modeled_seconds"] == trace["cost"]["total_seconds"],
          f"replay: modeled {res['modeled_seconds']} s, estimate_cost "
          f"{trace['cost']['total_seconds']} s")
    check(res["rows"] == trace["rows"], "replay: rows")
    log("replay_trace: " + json.dumps(res))
    return res


def phase_hbm(dev) -> dict:
    """``tools/hbm_calibrate.py`` on the card: read, int8-weight product
    and copy bandwidth through torch ops, beside the 3.35 TB/s data
    sheet."""
    from spatten_tpu_torch.tools import hbm_calibrate
    res = hbm_calibrate.calibrate(dev)
    check(all(math.isfinite(r["gbps"]) and r["gbps"] > 0 for r in res),
          "hbm: a bandwidth is not a positive number")
    log("hbm_calibrate:\n  " + "\n  ".join(hbm_calibrate.lines(res)))
    free()
    return {r["name"]: r for r in res}


# phase_bench: tools.bench's third point, short (the full bench: PERF.md)
BENCH_POINT, BENCH_STEPS, BENCH_REPEATS = (4096, 16), 16, 1


@contextlib.contextmanager
def counted(into: dict, name: str, reset: bool = True):
    """K1's and K2's launches over the block into ``into[name]`` (added to
    what it holds): the counts set to 0 just before it (``reset``; a block
    inside a counted one reads its own launches as a difference) and read
    just after."""
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    if reset:
        fused_decode_attention.launches = gather_compact_rows.launches = 0
    start = fused_decode_attention.launches, gather_compact_rows.launches
    yield
    k1, k2 = into.get(name, (0, 0))
    into[name] = (k1 + fused_decode_attention.launches - start[0],
                  k2 + gather_compact_rows.launches - start[1])


def bench_window_vs_plain(cfg, params, dev, steps: int) -> dict:
    """The bench's first decode window (``tools.bench.time_decode``'s: the
    warmed cache, the prune check and head-mask clock, ``steps`` greedy
    steps) with the kernels, then again through the plain versions from
    the same warmed state, fed the same tokens."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops import rope as rope_ops
    from spatten_tpu_torch.tools import bench as tb
    b = cfg.engine.max_batch_size
    snap = tb.warm_cache_content(cfg, tb.warm_state(
        cfg, init_state(cfg, batch=b, device=dev)))
    tables = rope_ops.rope_table(cfg.engine.cache_capacity,
                                 cfg.model.head_dim, cfg.model.rope_theta,
                                 dev)

    def window(state, fed=None):
        state, _ = gen.maybe_prune(cfg, state, steps, static_layers=())
        state = gen.maybe_update_head_mask(cfg, state, window=steps)
        tok = torch.zeros((b,), dtype=torch.int32, device=dev)
        toks, logits_all = [], []
        for i in range(steps):
            if fed is not None:
                tok = fed[i]
            logits, state, _ = tr.forward(params, cfg, state, tok[:, None],
                                          rope_tables=tables)
            toks.append(tok)
            logits_all.append(logits[:, -1])
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        return toks, torch.stack(logits_all)

    fed, lk = window(snap.clone())
    with plain_versions():
        _, lp = window(snap, fed)
    check(bool(torch.isfinite(lk).all()), "bench window: non-finite logits")
    mean_err = float((lk - lp).abs().mean())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    exact = float((lk == lp).float().mean())
    check(mean_err <= WINDOW_MEAN_TOL, f"bench window mean error {mean_err}")
    check(agree >= WINDOW_ARGMAX_MIN, f"bench window argmax {agree}")
    return dict(mean_err=mean_err, argmax=agree, exact=exact)


def phase_bench(dev) -> dict:
    """``tools.bench.run_point`` at its third point (4096 x 16), 16 steps,
    one timed window, no extras, int8 weights from seed 0: K1 launches =
    layers x steps x (1 + repeats) in each engine's ``time_decode``, K2's
    in ``measure_prune`` = the layer compactions of the events it ran, a
    requant rate in (0, 1); the spatten engine's first window against the
    plain versions; the point's JSON on a line of its own."""
    from spatten_tpu_torch.tools import bench as tb
    counts, runs = {}, []
    real_decode, real_prune = tb.time_decode, tb.measure_prune

    def time_decode(cfg, *a, **kw):
        name = "spatten" if cfg.quant.enabled else "dense"
        with counted(counts, name, reset=False):
            return real_decode(cfg, *a, **kw)

    def measure_prune(cfg, params, *a, **kw):
        runs.extend(tb.prune_runs(cfg))
        with counted(counts, "prune", reset=False):
            return real_prune(cfg, params, *a, **kw)

    cache, batch = BENCH_POINT
    params = tb.bench_params(dev)
    tb.time_decode, tb.measure_prune = time_decode, measure_prune
    try:
        with counted(counts, "point"):
            point = tb.run_point(cache, batch, BENCH_STEPS, params,
                                 device=dev, repeats=BENCH_REPEATS)
    finally:
        tb.time_decode, tb.measure_prune = real_decode, real_prune
    layers = tb.shard_model_cfg().num_layers
    want = layers * BENCH_STEPS * (1 + BENCH_REPEATS)
    for name in ("spatten", "dense"):
        check(counts[name][0] == want, f"bench {name}: K1 launched "
              f"{counts[name][0]} times, not {want}")
    events = sum(len(layers_) * 2 * n for layers_, n in runs)
    check(counts["prune"][1] == events and events > 0,
          f"bench measure_prune: K2 launched {counts['prune'][1]} times for "
          f"{events} layer compactions")
    check(0.0 < point["requant_rate"] < 1.0,
          f"bench requant rate {point['requant_rate']}")
    check(all(x > 0 for x in (point["spatten_tok_s"],
                              point["dense_int8_tok_s"],
                              point["prune_ms_per_event"])),
          "bench: a rate or time is not positive")
    cfg_sp = tb.build_cfg(True, cache, batch)
    cfg_sp = dataclasses.replace(cfg_sp, quant=dataclasses.replace(
        cfg_sp.quant, requant_threshold=point["requant_threshold"]))
    with counted(counts, "window check"):
        win = bench_window_vs_plain(cfg_sp, params, dev, BENCH_STEPS)
    del params
    free()
    log(json.dumps({"bench_point": point}))
    log(f"bench {cache}x{batch}: K1 {counts['spatten'][0]} + "
        f"{counts['dense'][0]} launches in the two engines' windows "
        f"({want} each), K2 {counts['prune'][1]} in measure_prune "
        f"({len(runs)} runs); first window vs plain: mean |logit diff| "
        f"{win['mean_err']:.2e}, argmax {win['argmax']:.4f}, bit-equal "
        f"{win['exact']:.4f}")
    return dict(point=point, window=win, k1=counts["point"][0],
                k2=counts["point"][1])


def phase_bench_tools(dev) -> dict:
    """One short run of each bench tool, in-process, at 4096 x 16 and 8
    steps a window: ``profile_fused``, ``bisect_bench``, ``vprune_sweep``,
    ``prefill_diag`` (prompt 1024), ``profile_decode`` (the spatten
    ladder with its profiler trace, and the kernel ladder with
    ``_skip_append``), ``microbench`` (bw at small sizes, floor); every
    time finite and positive, and each tool but the prefill and bandwidth
    ones launching K1."""
    import os
    from spatten_tpu_torch.tools import (
        bisect_bench, microbench, prefill_diag, profile_decode,
        profile_fused, vprune_sweep,
    )
    cache, batch = BENCH_POINT
    env = {"SPATTEN_BENCH_CACHE": str(cache), "SPATTEN_BENCH_BATCH":
           str(batch), "SPATTEN_BENCH_STEPS": "8", "CACHE": str(cache),
           "BATCH": str(batch), "STEPS": "8", "SPATTEN_PROFILE_TRACE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    counts, out = {}, {}
    args = [str(cache), str(batch)]
    runs = {
        "profile_fused": lambda: profile_fused.main(dev),
        "bisect_bench": lambda: bisect_bench.main(dev),
        "vprune_sweep": lambda: vprune_sweep.main(args, dev),
        "prefill_diag": lambda: prefill_diag.main(["1024"] + args, dev),
        "profile_decode spatten": lambda: profile_decode.main(
            ["spatten"] + args, dev),
        "profile_decode kernel-ladder": lambda: profile_decode.main(
            ["kernel-ladder"] + args, dev),
        "microbench bw": lambda: microbench.bench_bw(
            dev, sizes=((16, 64), (1, 8)), dot_shape=(2, 4096, 8192, 16)),
        "microbench floor": lambda: microbench.main(["floor"], dev),
    }
    try:
        for name, fn in runs.items():
            t0 = time.perf_counter()
            with counted(counts, name):
                res = fn()
            out[name] = res
            # the tools' times: a dict's values, a table's last column
            vals = (list(res.values()) if isinstance(res, dict)
                    else [row[-1] for row in res])
            check(all(isinstance(v, float) and math.isfinite(v) and v > 0
                      for v in vals), f"{name}: a time is not positive")
            # prefill runs no K1 (its attention is torch code), and bw
            # times torch ops
            if name not in ("prefill_diag", "microbench bw"):
                check(counts[name][0] > 0, f"{name}: K1 did not launch")
            log(f"[tool {name}: {time.perf_counter() - t0:.1f} s, K1 "
                f"{counts[name][0]} launches]")
            free()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    trace_dir = profile_decode.TRACE_DIR
    check(trace_dir.is_dir() and any(trace_dir.iterdir()),
          "profile_decode wrote no profiler trace")
    return dict(k1=sum(c[0] for c in counts.values()), counts=counts)


PPL_STEPS = 300          # the phase's training steps (the tool's: 1200)
# Kernels vs plain over the one-token run, teacher-forced, f32 weights.
# Under the tool's flags (f32 queries, f32 P·V) K1 forms its dot products
# and P·V sums in another order than the plain version: on an H100 12 of
# the 6,132 calls' outputs are bit-equal, the rest within 3.7e-5, and
# the differences reach the next layer's queries and the keep decisions
# downstream.  tools/plain_gap.py read the NLL gap over 2 models x 3
# texts at 2.1e-5 .. 5.3e-4 (this run's text: 1.9e-4), and with the
# probabilities rounded to bf16 in the plain version (a planted fault) at
# 1.4e-3 .. 2.7e-3: PPL_NLL_RTOL sits between.  With int8 queries and
# integer P·V (PPL_EXACT_FLAGS) every sum K1 takes is the plain
# version's, and the NLLs are equal.
PPL_NLL_RTOL = 8e-4
PPL_EXACT_FLAGS = dict(quantize_queries=True, pv_int8=True)
PPL_EXACT_TOKENS = 128   # its text: the first 128 predictions (run time)
PPL_RUNS = ("dense", "keep 0.5", "keep 0.25", "keep 0.5, one-token chunks",
            "keep 0.5, one-token chunks, int8 queries")


def ppl_prune_points(cfg, tokens: int) -> int:
    """The cascade prunes ``evaluate_perplexity`` makes over ``tokens``
    tokens (K2 launches on the card: one per triggered layer)."""
    from spatten_tpu_torch.engine import generate as gen
    lens, points, pos = [0] * cfg.model.num_layers, 0, 0
    while pos < tokens - 1:
        n = min(cfg.engine.prefill_chunk, tokens - 1 - pos)
        layers, lens = gen.prune_schedule_step(cfg, lens, n)
        points, pos = points + len(layers), pos + n
    return points


def ppl_runs(sc) -> dict:
    """``PPL_RUNS``' configurations, from ``tools/ppl_curve.py``'s rows at
    scale ``sc``."""
    from spatten_tpu_torch.tools import ppl_curve as pc
    rows = dict(pc.configs(sc))
    keep50 = rows["spatten keep~0.50 (4b+requant+vprune)"]
    ones = dataclasses.replace(keep50, engine=dataclasses.replace(
        keep50.engine, prefill_chunk=1))
    return dict(zip(PPL_RUNS, (
        rows["dense fp (full context)"], keep50,
        rows["spatten keep~0.25 (4b+requant+vprune)"], ones,
        dataclasses.replace(ones, quant=dataclasses.replace(
            ones.quant, **PPL_EXACT_FLAGS)))))


@contextlib.contextmanager
def plain_versions():
    """While active, the model's decode steps call K1's plain version and
    the prune compaction K2's, on the card's tensors."""
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows_plain
    from spatten_tpu_torch.ops.fused_decode import (
        fused_decode_attention_plain,
    )
    from spatten_tpu_torch.pruning import compact
    saved = tr.fused_decode_attention, compact.gather_compact_rows
    tr.fused_decode_attention = fused_decode_attention_plain
    compact.gather_compact_rows = gather_compact_rows_plain
    try:
        yield
    finally:
        tr.fused_decode_attention, compact.gather_compact_rows = saved


def extract_corpus_in_background(path=None):
    """Start ``tools/extract_doc_corpus.py`` in a process of its own, its
    report going to ``<corpus>.log`` (the ppl phase waits for it; mining
    the card machine's packages takes about two minutes, which the kernel
    build hides).  Returns (the process, the log's path)."""
    from pathlib import Path
    from spatten_tpu_torch.tools import extract_doc_corpus
    path = Path(path or extract_doc_corpus.DEFAULT_OUT)
    path.parent.mkdir(parents=True, exist_ok=True)
    log_path = path.with_suffix(".log")
    with open(log_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-W", "ignore::SyntaxWarning", "-m",
             "spatten_tpu_torch.tools.extract_doc_corpus", str(path)],
            stdout=subprocess.DEVNULL, stderr=err)
    return proc, log_path


def phase_ppl(dev, steps: int = PPL_STEPS, sc=None, corpus_path=None,
              roots=None, corpus_proc=None) -> dict:
    """The accuracy path (``tools/ppl_curve.py``) at GPT-2 small's
    geometry (12 layers x 12 heads x 64, vocab 256, context 512): the
    docstring corpus extracted into ``build/``, ``steps`` training steps
    (f32 weights, TF32 matmuls), then the held-out text's perplexity
    through the kernels: dense, keep 0.5 and keep 0.25 (16-token chunks:
    K2 for every prune, no one-token chunk), and keep 0.5 again with
    ``prefill_chunk`` = 1, teacher-forced decode through K1 at every
    token (511 x 12 launches), rerun through K1's and K2's plain versions
    (``plain_versions``) with its NLL within
    ``PPL_NLL_RTOL``; then once more with ``PPL_EXACT_FLAGS`` over the
    first ``PPL_EXACT_TOKENS`` predictions, where the
    NLLs must be equal.  K1 and K2 launches equal the schedule's.
    ``corpus_proc``: (process, log) of the extraction started by
    ``extract_corpus_in_background`` (else it runs here).  ``sc``,
    ``corpus_path``, ``roots``: a rehearsal's scale, corpus file and
    package roots."""
    from spatten_tpu_torch.eval import evaluate_perplexity
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import (
        gather_compact_rows, k2_takes,
    )
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.tools import extract_doc_corpus, ppl_curve as pc
    sc = sc or pc.SCALES["gpt2s"]
    corpus_path = corpus_path or extract_doc_corpus.DEFAULT_OUT
    roots = roots or extract_doc_corpus.default_roots()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    if corpus_proc is not None:
        proc, log_path = corpus_proc
        rc = proc.wait()
        err = log_path.read_text().strip()
        check(rc == 0, f"ppl: corpus extraction failed:\n{err}")
        log(f"ppl: corpus from {roots} (in the background, waited "
            f"{time.perf_counter() - t0:.1f} s): {err.splitlines()[-1]}")
    else:
        n_docs, chars = extract_doc_corpus.extract(roots, corpus_path)
        log(f"ppl: corpus of {n_docs} docstrings, {chars / 1e6:.1f} MB, "
            f"extracted from {roots} in {time.perf_counter() - t0:.1f} s")
    corpus = pc.Corpus.load(corpus_path)
    t0 = time.perf_counter()
    params = pc.train(steps, sc, corpus, dev, log=log)
    sync()
    train_s = time.perf_counter() - t0
    log(f"ppl: {sc.name} trained {steps} steps at batch {sc.batch} x "
        f"{sc.seq} in {train_s:.1f} s")
    text, _ = pc.eval_texts(sc, corpus)
    runs = ppl_runs(sc)
    texts = dict.fromkeys(PPL_RUNS, text)
    texts[PPL_RUNS[4]] = text[:PPL_EXACT_TOKENS + 1]
    out = {}
    for name, cfg in runs.items():
        L, t = cfg.model.num_layers, texts[name]
        fused_decode_attention.launches = 0
        gather_compact_rows.launches = 0
        t0 = time.perf_counter()
        r = evaluate_perplexity(params, cfg, t, device=dev)
        sync()
        secs = time.perf_counter() - t0
        k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
        chunk = cfg.engine.prefill_chunk
        ones = sum(min(chunk, len(t) - 1 - p) == 1
                   for p in range(0, len(t) - 1, chunk))
        k1_want = (L * ones if on_card and tr.decode_uses_kernel(cfg, "cuda")
                   else 0)
        k2_want = (ppl_prune_points(cfg, len(t))
                   if on_card and k2_takes(cfg.model.head_dim) else 0)
        check(math.isfinite(r.nll), f"ppl {name}: NLL {r.nll}")
        check(k1 == k1_want, f"ppl {name}: K1 launched {k1}, not {k1_want}")
        check(k2 == k2_want, f"ppl {name}: K2 launched {k2}, not {k2_want}")
        out[name] = dict(ppl=r.perplexity, nll=r.nll, tokens=r.num_tokens,
                         requant_events=r.requant_events, k1=k1, k2=k2,
                         seconds=secs)
        log(f"ppl {name}: {r.perplexity:.4f} (NLL {r.nll:.6f} over "
            f"{r.num_tokens} tokens; cache {cfg.engine.cache_capacity}, "
            f"chunk {chunk}; requant events {r.requant_events}) in "
            f"{secs:.1f} s; K1 launches {k1}, K2 launches {k2}")
    check(out["dense"]["ppl"] < sc.vocab / 4, f"ppl: dense perplexity "
          f"{out['dense']['ppl']} is not far below chance ({sc.vocab})")
    # the one-token runs again through the plain versions
    vs_plain = {}
    for name, rtol in ((PPL_RUNS[3], PPL_NLL_RTOL), (PPL_RUNS[4], 0.0)):
        with plain_versions():
            r = evaluate_perplexity(params, runs[name], texts[name],
                                    device=dev)
        got = out[name]["nll"]
        rel = abs(got - r.nll) / abs(r.nll)
        vs_plain[name] = dict(plain_nll=r.nll, rel=rel)
        log(f"ppl {name}, kernels vs plain: NLL {got!r} vs {r.nll!r}, "
            f"relative {rel:.2e} (tolerance {rtol})")
        check(rel <= rtol, f"ppl {name}: kernels vs plain NLL relative "
              f"{rel}")
    del params
    free()
    return dict(out, steps=steps, train_s=train_s, corpus_mb=len(
        corpus.data) / 1e6, vs_plain=vs_plain)


SUPERVISED_BATCH, SUPERVISED_NEW, SUPERVISED_WINDOW = 2, 64, 16


def _dir_bytes(path) -> int:
    from pathlib import Path
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


def phase_supervised(dev) -> dict:
    """``engine.supervisor.generate_supervised`` on ``serving_config(8)``
    (Llama-2-7B width, depth 8, random bf16 weights), batch 2, capacity
    4096, prompt 3072 (prunes fire in prefill, so K2 moves rows), 64 new
    tokens in windows of 16, snapshots in a temporary directory removed at
    the end; three ways: uninterrupted, with a health probe that fails
    once before the third window (the latest snapshot is restored and the
    window replays), and 32 tokens then a fresh ``resume=True`` call to
    64.  The three token streams must be equal exactly.  Prints the
    snapshot bytes, the seconds per snapshot, per restore and of the
    one-time params checkpoint, and K1/K2 launches of the uninterrupted
    run; then holds its first window against the plain versions
    (``window_vs_plain``)."""
    import shutil
    import tempfile
    from spatten_tpu_torch.engine import checkpoint, supervisor
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import (
        gather_compact_rows, k2_takes,
    )
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    base = serving_config(8)
    cfg = dataclasses.replace(base, engine=dataclasses.replace(
        base.engine, max_batch_size=SUPERVISED_BATCH)).validate()
    m = cfg.model
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    prompt = np.random.default_rng(SEED).integers(
        0, m.vocab_size, (SUPERVISED_BATCH, SERVING_PROMPT))
    secs = {"snapshot": [], "params": [], "restore": [], "params restore": []}
    save, restore = checkpoint.save, checkpoint.restore_with_extra

    def timed_save(path, p, state=None, extra=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(path, p, state, extra)
        secs["snapshot" if p is None else "params"].append(
            time.perf_counter() - t0)

    def timed_restore(path, device="cuda"):
        t0 = time.perf_counter()
        out = restore(path, device)
        torch.cuda.synchronize()
        secs["params restore" if out[0] is not None else "restore"].append(
            time.perf_counter() - t0)
        return out

    root = tempfile.mkdtemp(prefix="spatten-supervised-")
    checkpoint.save, checkpoint.restore_with_extra = timed_save, timed_restore
    try:
        def run(name, n, **kw):
            return supervisor.generate_supervised(
                kw.pop("params", params), cfg, prompt, n,
                f"{root}/{name}", window=SUPERVISED_WINDOW, device=dev,
                **dict(dict(health=lambda: True), **kw))
        fused_decode_attention.launches = gather_compact_rows.launches = 0
        t0 = time.perf_counter()
        want = run("a", SUPERVISED_NEW)
        run_s = time.perf_counter() - t0
        k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
        snap_bytes = _dir_bytes(f"{root}/a/supervised-{SUPERVISED_NEW}")
        params_bytes = _dir_bytes(f"{root}/a/params")
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            return calls["n"] != 3
        killed = run("b", SUPERVISED_NEW, health=flaky)
        run("c", SUPERVISED_NEW // 2)
        resumed = run("c", SUPERVISED_NEW, params=None, resume=True)
    finally:
        checkpoint.save, checkpoint.restore_with_extra = save, restore
        shutil.rmtree(root, ignore_errors=True)
    check(tuple(want.shape) == (SUPERVISED_BATCH, SUPERVISED_NEW),
          "supervised: token shape")
    # prefill prunes; K2 moves the rows where it takes the head_dim
    check(k1 == m.num_layers * SUPERVISED_NEW
          and (k2 > 0) is k2_takes(m.head_dim),
          f"supervised: K1 launched {k1}, K2 {k2}")
    same_killed = bool(torch.equal(killed, want))
    same_resumed = bool(torch.equal(resumed, want))
    log(f"supervised (Llama-2-7B width, depth {m.num_layers}, batch "
        f"{SUPERVISED_BATCH}, prompt {SERVING_PROMPT}, {SUPERVISED_NEW} "
        f"tokens in windows of {SUPERVISED_WINDOW}): uninterrupted run "
        f"{run_s:.2f} s, K1 launches {k1}, K2 launches {k2}; snapshot "
        f"{snap_bytes} B (state only), {len(secs['snapshot'])} snapshots "
        f"at {np.mean(secs['snapshot']):.3f} s each (max "
        f"{max(secs['snapshot']):.3f}), restores "
        f"{[round(x, 3) for x in secs['restore']]} s; params checkpoint "
        f"{params_bytes} B written in {secs['params'][0]:.3f} s (once per "
        f"directory: {[round(x, 3) for x in secs['params']]}), read in "
        f"{[round(x, 3) for x in secs['params restore']]} s; probe failed "
        f"once of {calls['n']} calls; tokens equal to the uninterrupted "
        f"run's: killed window {same_killed}, resumed {same_resumed}")
    check(same_killed and same_resumed, "supervised: the interrupted or "
          "resumed token stream differs from the uninterrupted one")
    # K1 and the compaction at this path's shapes against their plain
    # versions: the first window of 16 from a fresh prefill
    state = window_vs_plain("supervised", cfg, dev, params,
                            prompt, want.to(dev), steps=SUPERVISED_WINDOW)[0]
    del params, state
    free()
    return dict(k1=k1, k2=k2, snapshot_bytes=snap_bytes,
                snapshot_s=float(np.mean(secs["snapshot"])),
                restore_s=secs["restore"], params_s=secs["params"][0])


CLI_LAYERS, CLI_NEW, CLI_TURNS = 4, 32, (800, 300)
# meta-llama/Llama-2-7b-hf's published config.json (the widths of every
# Llama-2-7B cell)
LLAMA2_7B_HF_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "hidden_size": 4096, "intermediate_size": 11008,
    "num_attention_heads": 32, "num_key_value_heads": 32,
    "num_hidden_layers": 32, "vocab_size": 32000,
    "max_position_embeddings": 4096, "rms_norm_eps": 1e-5,
    "rope_theta": 10000.0, "tie_word_embeddings": False, "bos_token_id": 1,
    "eos_token_id": 2, "pad_token_id": 0, "hidden_act": "silu",
    "torch_dtype": "float16"}


def write_random_llama(path, num_layers: int, seed: int = SEED) -> dict:
    """A Hugging Face ``llama`` checkpoint at Llama-2-7B width
    (``config.json`` and ``pytorch_model.bin``, random bf16 weights from
    the seed at 0.02 scale, unit norms) of ``num_layers`` layers."""
    from pathlib import Path
    hf = dict(LLAMA2_7B_HF_CONFIG, num_hidden_layers=num_layers)
    h, f, v = hf["hidden_size"], hf["intermediate_size"], hf["vocab_size"]
    gen = torch.Generator().manual_seed(seed)

    def w(*shape):
        return (0.02 * torch.randn(shape, generator=gen)).to(torch.bfloat16)
    sd = {"model.embed_tokens.weight": w(v, h), "lm_head.weight": w(v, h),
          "model.norm.weight": torch.ones(h, dtype=torch.bfloat16)}
    for i in range(num_layers):
        pre = f"model.layers.{i}."
        for name in ("q", "k", "v", "o"):
            sd[pre + f"self_attn.{name}_proj.weight"] = w(h, h)
        sd[pre + "mlp.gate_proj.weight"] = w(f, h)
        sd[pre + "mlp.up_proj.weight"] = w(f, h)
        sd[pre + "mlp.down_proj.weight"] = w(h, f)
        for name in ("input_layernorm", "post_attention_layernorm"):
            sd[pre + f"{name}.weight"] = torch.ones(h, dtype=torch.bfloat16)
    Path(path).mkdir(parents=True, exist_ok=True)
    (Path(path) / "config.json").write_text(json.dumps(hf))
    torch.save(sd, str(Path(path) / "pytorch_model.bin"))
    return hf


def phase_cli(dev) -> dict:
    """``run_spatten_gpu.py`` as a user runs it, in a subprocess: a random
    Llama-2-7B-width checkpoint of ``CLI_LAYERS`` layers
    (``write_random_llama``) and a prompts file of one ``ids`` record of
    two turns (800 and 300 tokens: the second prunes the 1024-token
    cache), 32 new tokens a turn, with ``--trace_csv`` and ``--summary``.
    Checked: exit 0; the printed reply ids equal an in-process
    ``generate`` on the same loaded params and state sequence, whose K1
    and K2 launches are counted (K1: layers x tokens a turn); the trace
    has a row per traced step, layer and kv head; the summary holds the
    run metrics' fields; the first turn's first decode window against the
    plain versions (``window_vs_plain``)."""
    import shutil
    import tempfile
    from pathlib import Path
    import run_spatten_gpu as cli
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine import trace as trc
    from spatten_tpu_torch.engine.metrics import RunMetrics
    from spatten_tpu_torch.models import hf_loader
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    root = Path(tempfile.mkdtemp(prefix="spatten-cli-"))
    try:
        t0 = time.perf_counter()
        hf = write_random_llama(root / "ckpt", CLI_LAYERS)
        write_s = time.perf_counter() - t0
        rng = np.random.default_rng(SEED)
        turns = [rng.integers(3, hf["vocab_size"], n).tolist()
                 for n in CLI_TURNS]
        (root / "prompts.jsonl").write_text(json.dumps({"ids": turns}))
        argv = ["--model_path", str(root / "ckpt"), "--prompts",
                str(root / "prompts.jsonl"), "--max_new_tokens",
                str(CLI_NEW), "--trace_csv", str(root / "trace.csv"),
                "--summary", str(root / "summary.json"), "--device", dev.type]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(cli.__file__).resolve()), *argv],
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"run_spatten_gpu.py exited "
              f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-4000:]}")
        got = [json.loads(line.split("reply ids: ", 1)[1])
               for line in proc.stdout.splitlines()
               if line.startswith("reply ids: ")]
        # the same run in process: the loader, the CLI's configuration
        mcfg, params = hf_loader.load_pretrained(str(root / "ckpt"),
                                                 device=dev)
        cfg = cli.build_config(cli.parse_args(argv), mcfg)
        state, want, lengths, first = None, [], [], None
        fused_decode_attention.launches = gather_compact_rows.launches = 0
        for t in turns:
            res = gen.generate(params, cfg, torch.tensor([t]), CLI_NEW,
                               eos_token_id=hf["eos_token_id"], state=state,
                               device=dev)
            state = res.state
            first = res.tokens if first is None else first
            want.append([x for x in res.tokens[0].tolist()
                         if x != hf["eos_token_id"]])
            lengths.append(int(state.lengths[0]))
        k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
        rows = trc.read_csv(str(root / "trace.csv"))
        summary = json.loads((root / "summary.json").read_text())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    m = mcfg
    steps = min(8, CLI_NEW)
    check(got == want, "CLI replies differ from the in-process generate")
    check(k1 == m.num_layers * CLI_NEW * len(turns),
          f"cli: K1 launched {k1} times in the in-process replay")
    check(len(rows) == steps * m.num_layers * m.num_kv_heads,
          f"CLI trace has {len(rows)} rows")
    fields = set(RunMetrics().summary())
    check(fields <= set(summary) and summary["generated_tokens"] == CLI_NEW,
          f"CLI summary {sorted(summary)}")
    log(f"cli: run_spatten_gpu.py on a random Llama-2-7B-width checkpoint "
        f"({CLI_LAYERS} layers, written in {write_s:.1f} s), turns "
        f"{list(CLI_TURNS)} ids, {CLI_NEW} new tokens each: exit 0 in "
        f"{cli_s:.1f} s; replies equal the in-process generate "
        f"({sum(map(len, got))} ids; cache lengths {lengths}); trace "
        f"{len(rows)} rows = {steps} steps x {m.num_layers} layers x "
        f"{m.num_kv_heads} kv heads; summary {len(summary)} fields, "
        f"{summary['generated_tokens']} generated, requant rate "
        f"{summary['requant_rate']}; in-process replay K1 launches {k1}, "
        f"K2 {k2}")
    state = window_vs_plain(
        "cli", cfg, dev, params, np.asarray(turns[:1]), first,
        steps=min(CLI_NEW, gen.decode_window_steps(cfg)))[0]
    del params, state
    free()
    return dict(seconds=cli_s, rows=len(rows), k1=k1, k2=k2)


def phase_debug_hook(dev) -> dict:
    """``generate`` under ``SPATTEN_DEBUG=1`` (its first prefill chunk,
    and only that one, under ``utils.debug.checkify_step``) on the first
    slice at depth 2 (random bf16 weights, batch 4, prompt 1152: prefill
    prunes), against the same run without the flag: tokens equal; and the
    checks trap a NaN made by an op on the card."""
    import os
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.utils import debug as dbg
    cfg = slice_config(2)
    m = cfg.model
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    prompt = np.random.default_rng(SEED).integers(0, m.vocab_size,
                                                  (4, 1152))
    # the checks trap a NaN that an op makes on the card
    try:
        dbg.checkify_step(torch.log, -torch.ones(4, device=dev))
        trapped = False
    except FloatingPointError:
        trapped = True
    plain = gen.generate(params, cfg, prompt, 32, device=dev)
    checked, real = [], dbg.checkify_step

    def counted(fn, *args, **kw):
        checked.append(tuple(args[1].shape))      # the chunk's tokens
        return real(fn, *args, **kw)
    os.environ["SPATTEN_DEBUG"] = "1"
    dbg.checkify_step = counted
    try:
        check(dbg.enabled(), "SPATTEN_DEBUG is not read")
        fused_decode_attention.launches = gather_compact_rows.launches = 0
        t0 = time.perf_counter()
        debug = gen.generate(params, cfg, prompt, 32, device=dev)
        secs = time.perf_counter() - t0
        k1, k2 = (fused_decode_attention.launches,
                  gather_compact_rows.launches)
    finally:
        dbg.checkify_step = real
        del os.environ["SPATTEN_DEBUG"]
    same = bool(torch.equal(debug.tokens, plain.tokens))
    log(f"debug hook: generate under SPATTEN_DEBUG=1 (first slice, depth 2, "
        f"batch 4, prompt 1152, 32 tokens) in {secs:.2f} s, the float "
        f"checks over prefill chunks {checked} (prefill "
        f"{debug.prefill_seconds:.2f} s vs {plain.prefill_seconds:.2f} s "
        f"without); a NaN made on the card trapped: {trapped}; prune "
        f"points {len(debug.pruned_layers)}; K1 launches {k1}, K2 {k2}; "
        f"tokens equal the run without it: {same}")
    check(trapped and checked == [(4, cfg.engine.prefill_chunk)],
          "debug hook: the float checks did not run on the first chunk")
    check(same and debug.pruned_layers == plain.pruned_layers,
          "debug hook: tokens differ from the run without it")
    check(k1 == m.num_layers * 32, f"debug hook: K1 launched {k1} times")
    del params
    free()
    return dict(seconds=secs, prefill_s=debug.prefill_seconds,
                plain_prefill_s=plain.prefill_seconds, k1=k1, k2=k2)


def probe_entries(probe: dict, launches: dict) -> list:
    """The ``kernels`` JSON entries of P1-P5 from ``phase_launch_probe``'s
    result; ``launches``: each probe's count on the serving path."""
    from spatten_tpu_torch.tools import launch_overhead as lo
    pres, out = probe["res"], []
    for pid, (kern, _, replaces, _) in lo.PROBES.items():
        r = pres[pid]
        entry = dict(
            name=f"{pid} {kern.__name__}", route="cuda",
            source="spatten_tpu_torch/csrc/launch_probe.cu",
            replaces=replaces, launches=launches[pid],
            max_abs_err=probe["errs"][pid], ms=r["device_us"] / 1e3,
            plain_ms=r["plain_us"] / 1e3, bound_ms=r["bound_us"] / 1e3,
            bound_by="bytes", library_ms=r["library_us"] / 1e3,
            floor_ms=r["floor_us"] / 1e3,
            probe_launches=probe["counts"][pid],
            eager_us=r["eager_us"], graph_us=r["graph_us"])
        med = pres["interleaved"].get(pid)
        if med is not None:
            # the redesigned probes: interleaved medians of one call, and
            # the kernels that the same-function call launches
            library = {"P2": "torch.add(x, 1.0, out=o)",
                       "P3": "plane[:256].sum()",
                       "P4": "plane[:8].add_(1)",
                       "P5": "torch.add(x, s[0], out=o)"}[pid]
            entry.update(ms=med[f"{pid} kernel"] / 1e3,
                         library_ms=med[library] / 1e3,
                         floor_ms=med["launch floor"] / 1e3,
                         interleaved_us=med,
                         library_kernels=pres["kernels per call"][library])
        if pid == "P5":
            entry["library_host_scalar_ms"] = \
                r["library_host_scalar_us"] / 1e3
        out.append(entry)
    return out


def small_reference_check(dev):
    """A small GQA model (head_dim 64, group 2) in f32: the kernels vs the
    plain versions, both on the card, from the same weights and prompt.
    Prefill (three prunes, through K2 or the gather) must give equal
    logits; then five decode windows (a decode prune before the fourth;
    K1 every step) fed the plain path's tokens, step by step."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    cfg = SpAttenConfig(
        model=ModelConfig(vocab_size=512, hidden_size=256, num_layers=3,
                          num_heads=4, num_kv_heads=2, head_dim=64,
                          intermediate_size=512),
        pruning=PruningConfig(start_size=4, important_size=16,
                              recent_size=32, v_block_size=16),
        quant=QuantConfig(requant_threshold=0.1),
        engine=EngineConfig(max_batch_size=2, cache_capacity=128,
                            prefill_chunk=32, decode_window=16),
    ).validate()
    cfgs = {"kernel": cfg, "plain": dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, use_pallas=False))}
    params = tr.init_params(cfg.model, SEED, dtype=torch.float32, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, 512, (2, 280))).to(dev)
    state, last = {}, {}
    for k, c in cfgs.items():
        last[k], state[k], host, pruned = gen.prefill(
            params, c, init_state(c, 2, device=dev), prompt)
    err = float((last["kernel"] - last["plain"]).abs().max())
    check(len(pruned) == 3, f"small model prefill pruned {pruned}")
    check(err <= 1e-5, f"small model prefill logits differ: {err}")
    tok = torch.argmax(last["plain"], -1).to(torch.int32)
    steps = gen.decode_window_steps(cfg)
    step_err, fired = [], {"kernel": 0, "plain": 0}
    for w in range(5):
        layers, host = gen.prune_schedule_step(cfg, host, steps)
        for k, c in cfgs.items():
            if layers:
                state[k], _ = gen.maybe_prune(c, state[k], steps,
                                              static_layers=layers)
        for _ in range(steps):
            logits = {}
            for k, c in cfgs.items():
                lg, state[k], aux = tr.forward(params, c, state[k],
                                               tok[:, None])
                logits[k] = lg[:, -1]
                fired[k] += int(aux.requant_events)
            step_err.append(float((logits["kernel"] - logits["plain"])
                                  .abs().max()))
            tok = torch.argmax(logits["plain"], -1).to(torch.int32)
    good = float(np.mean(np.asarray(step_err) <= SMALL_STEP_TOL))
    check(good >= SMALL_STEPS_MIN, f"small model: only {good:.2f} of decode "
          f"steps agree within {SMALL_STEP_TOL}")
    log(f"small model (f32, card kernels vs card plain): largest logit "
        f"{float(last['plain'].abs().max()):.2f}; prefill logits max |diff| "
        f"{err:.2e}; decode steps within {SMALL_STEP_TOL}: {good:.3f} of "
        f"{len(step_err)} (median {float(np.median(step_err)):.2e}, max "
        f"{max(step_err):.2e}); requant events {fired['kernel']} vs "
        f"{fired['plain']}")


def expected_schedule(cfg, prompt_len: int, new_tokens: int):
    """The host-side prune schedule: (K2 launches, final layer lengths,
    length clocks of the head mask updates)."""
    from spatten_tpu_torch.engine import generate as gen
    lens, points, clocks = [0] * cfg.model.num_layers, 0, []
    for pos in range(0, prompt_len, cfg.engine.prefill_chunk):
        layers, lens = gen.prune_schedule_step(
            cfg, lens, min(cfg.engine.prefill_chunk, prompt_len - pos))
        points += len(layers)
    p = cfg.pruning
    if p.enable_head_pruning and p.head_keep > 0:
        clocks.append(max(lens))
    steps = gen.decode_window_steps(cfg)
    for w in range(0, new_tokens, steps):
        n = min(steps, new_tokens - w)
        layers, lens = gen.prune_schedule_step(cfg, lens, n)
        points += len(layers)
        if gen.head_mask_due(cfg, max(lens) - n, n):
            clocks.append(max(lens) - n)
    return points, lens, clocks


def run_path(name, cfg, dev, *, batch, prompt_len, new_tokens,
             window_check=False, params=None):
    """Drive ``generate`` on one configuration with the launch counts set
    to 0 just before it and read just after; check the counts, lengths
    and head masks against the schedule; optionally rerun the first
    decode window through the plain versions; profile decode."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import (
        gather_compact_rows, k2_takes,
    )
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    m = cfg.model
    if params is None:
        t0 = time.perf_counter()
        params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        log(f"{name}: params {m.num_layers} layers, bf16, in "
            f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(SEED).integers(
        0, m.vocab_size, (batch, prompt_len))
    points, lens, clocks = expected_schedule(cfg, prompt_len, new_tokens)

    from spatten_tpu_torch.tools.launch_overhead import PROBES
    probes = [k for k, _, _, _ in PROBES.values()]
    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    for k in probes:
        k.launches = 0
    res = gen.generate(params, cfg, prompt, new_tokens, device=dev)
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    probe_launches = {pid: k.launches for pid, k in zip(PROBES, probes)}
    tokens = res.tokens
    check(tuple(tokens.shape) == (batch, new_tokens), "token shape")
    check(bool(((tokens >= 0) & (tokens < m.vocab_size)).all()),
          "tokens out of range")
    check(k1 == m.num_layers * new_tokens,
          f"{name}: K1 launched {k1} times, expected "
          f"{m.num_layers * new_tokens}")
    # K2 moves the rows of every layer a prune compacts, where it takes the
    # head_dim (else the gather does, as in the JAX compaction)
    k2_expect = points if k2_takes(m.head_dim) else 0
    check(k2 == k2_expect, f"{name}: K2 launched {k2} times, expected "
          f"{k2_expect}")
    check(res.state.layer_lengths.tolist() == [[lens[l]] * batch
                                               for l in range(m.num_layers)],
          f"{name}: layer lengths differ from the schedule")
    check(res.head_mask_updates == clocks, f"{name}: head mask updates at "
          f"{res.head_mask_updates}, expected {clocks}")
    p = cfg.pruning
    alive = res.state.head_mask.reshape(m.num_layers, m.num_kv_heads,
                                        -1).any(-1)
    if p.enable_head_pruning and p.head_keep > 0:
        check(alive.sum(-1).tolist() == [p.head_keep] * m.num_layers,
              f"{name}: alive kv heads per layer {alive.sum(-1).tolist()}")
        dropped = [torch.nonzero(~a)[:, 0].tolist() for a in alive]
        log(f"{name}: {p.head_keep} of {m.num_kv_heads} kv heads alive in "
            f"every layer; dropped heads by layer: {dropped}")
    tok_s = batch * new_tokens / res.decode_seconds
    log(f"{name}: prefill {res.prefill_seconds:.3f} s ({batch}x{prompt_len} "
        f"tokens), decode {res.decode_seconds:.3f} s = "
        f"{res.decode_seconds / new_tokens * 1e3:.2f} ms/step, {tok_s:.1f} "
        f"tok/s ({batch}x{new_tokens} tokens); prune points "
        f"{len(res.pruned_layers)} ({k2} layer compactions); requant events "
        f"{int(res.requant_events)} (decode, by layer: "
        f"{res.layer_requants.tolist()}); K1 launches {k1}, K2 launches {k2};"
        f" head mask updates at clocks {res.head_mask_updates}")
    out = dict(k1=k1, k2=k2, res=res, params=params, prompt=prompt,
               probe_launches=probe_launches)
    step_s = res.decode_seconds / new_tokens
    if window_check:
        state, tok, tables, host = window_vs_plain(name, cfg, dev, params,
                                                   prompt, tokens)
    else:
        state = res.state
        host = [int(x) for x in state.layer_lengths[:, 0].tolist()]
        tok = tokens[:, -1].to(torch.int32)
        from spatten_tpu_torch.ops import rope as rope_ops
        tables = rope_ops.rope_table(cfg.engine.cache_capacity, m.head_dim,
                                     m.rope_theta, dev)
    out["idle"] = profile_decode(name, params, cfg, state, tok, tables,
                                 step_s, host)
    out["tok_s"], out["step_ms"] = tok_s, step_s * 1e3
    del state
    return out


def window_vs_plain(name, cfg, dev, params, prompt, tokens, steps=None,
                    report=None):
    """The first decode window (``steps`` tokens, by default the
    configuration's window) again from a fresh prefill: kernels, then the
    plain versions (``plain_versions``) on the card from the same
    post-prefill state, fed the same tokens.  ``tokens``:
    generate's tokens, which the kernels' rerun should reproduce (None:
    not checked); ``report``: a dict that receives the window's numbers."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.policy import update_head_mask
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops import rope as rope_ops
    m = cfg.model
    batch = prompt.shape[0]
    state = init_state(cfg, batch, device=dev)
    last, state, host, _ = gen.prefill(params, cfg, state,
                                       torch.as_tensor(prompt, device=dev))
    if cfg.pruning.enable_head_pruning and cfg.pruning.head_keep > 0:
        state = update_head_mask(cfg, state)
    snap = state.clone()
    tables = rope_ops.rope_table(cfg.engine.cache_capacity, m.head_dim,
                                 m.rope_theta, dev)
    steps = steps or gen.decode_window_steps(cfg)
    tok = torch.argmax(last, -1).to(torch.int32)
    state, host_k, _, _ = gen.window_start(cfg, state, steps, list(host))
    fed, logits_k = [], []
    for _ in range(steps):
        logits, state, _ = tr.forward(params, cfg, state, tok[:, None], tables)
        fed.append(tok)
        logits_k.append(logits[:, -1])
        tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
    del state
    free()
    logits_p = []
    with plain_versions():
        state, _, _, _ = gen.window_start(cfg, snap, steps, list(host))
        for t in fed:
            logits, state, _ = tr.forward(params, cfg, state, t[:, None],
                                          tables)
            logits_p.append(logits[:, -1])
    lk, lp = torch.stack(logits_k), torch.stack(logits_p)   # [steps, B, V]
    check(bool(torch.isfinite(lk).all()), "non-finite logits")
    step_err = (lk - lp).abs().amax(dim=(1, 2)).tolist()
    mean_err = float((lk - lp).abs().mean())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    same = (None if tokens is None else
            bool(torch.equal(torch.stack(fed, 1), tokens[:, :steps])))
    exact = float((lk == lp).float().mean())
    pick = sorted({0, 1, 2, 4, 8, 16, 32, steps - 1} & set(range(steps)))
    log(f"{name}: first decode window, kernels vs plain on the card ({steps}"
        f" steps, same tokens fed): mean |logit diff| {mean_err:.2e} "
        f"(tolerance {WINDOW_MEAN_TOL}); argmax agreement {agree:.4f} (min "
        f"{WINDOW_ARGMAX_MIN}); max |diff| by step "
        f"{[round(step_err[i], 4) for i in pick]} (largest logit "
        f"{float(lk.abs().max()):.2f}); logits bit-equal {exact:.4f}; the "
        f"rerun reproduces generate's tokens: {same}")
    if report is not None:
        report.update(mean_err=mean_err, argmax=agree, exact=exact,
                      step_err=step_err)
    check(mean_err <= WINDOW_MEAN_TOL, f"window mean error {mean_err}")
    check(agree >= WINDOW_ARGMAX_MIN, f"argmax agreement {agree}")
    return state, tok, tables, host_k


def profile_decode(name, params, cfg, state, tok, tables, step_s: float,
                   host, steps: int = 8):
    """Device time per decode step, by kernel, from a torch.profiler trace
    of a few kernel-path steps (after a window boundary), against the
    host-clock step time of the unprofiled ``generate`` run: the device's
    busy and idle shares."""
    from torch.profiler import ProfilerActivity, profile
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    state, _, _, _ = gen.window_start(cfg, state, steps, list(host))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            logits, state, _ = tr.forward(params, cfg, state, tok[:, None],
                                          tables)
            tok = torch.argmax(logits[:, -1], -1).to(torch.int32)
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for ev in prof.key_averages():
        # device-side events only: a CPU op's entry repeats the device
        # time of the kernels it launched
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            t = ev.self_device_time_total / 1e3 / steps
            by_name[ev.key] = by_name.get(ev.key, 0.0) + t
            n_kernels += ev.count
    if not by_name:
        log(f"{name} profile: the trace holds no device time (not measured)")
        return None
    dev_ms = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    idle = 1 - dev_ms / (step_s * 1e3)
    log(f"{name} profile ({steps} decode steps, kernel path): device time "
        f"{dev_ms:.3f} ms/step vs {step_s * 1e3:.3f} ms/step host clock in "
        f"generate -> device busy {dev_ms / (step_s * 1e3):.3f}, idle "
        f"{idle:.3f}; {n_kernels / steps:.0f} device ops per step; top: "
        + "; ".join(f"{k[:48]} {v:.3f} ms" for k, v in top))
    return idle


# ---------------------------------------------------------------- meshes
# The multi-card slice.  On one card each phase spawns its ranks on cuda:0
# under gloo (NCCL refuses two ranks of one communicator on one card), so
# every kernel and matmul runs on the card and only the collectives go
# through the host; these times say nothing of NVLink.  With ``--cards N``
# (``main_cards``) rank r runs on cuda:r under NCCL, its collectives and
# hand-offs card to card.
MESH_NEW_TOKENS, MESH_WINDOW = 32, 16
# phase_sharded's depth (16 of Llama-2-7B's 32 layers, cut from 32 when
# the one-card run reached 1,065 s); the one-card pipeline runs MESH_DEPTH
# of them and phase_sharded_70b 4 of 80 (the one-card run's time limit;
# the four-card run's pipeline keeps 32)
SHARDED_DEPTH, MESH_DEPTH = 16, 8
MESH_TIMEOUT = 420


def llama2_70b_config(num_layers: int = 8, batch: int = 4):
    """Llama-2-70B's widths (``meta-llama/Llama-2-70b-hf`` config.json:
    hidden 8192, 64 query heads over 8 kv heads of 128, intermediate
    28672, vocab 32000) at ``num_layers`` of its 80 under the serving
    settings (``serving_config``), capacity 4096; head pruning keeps the
    serving share (3/4) of the kv heads."""
    base = serving_config(num_layers)
    model = dataclasses.replace(
        base.model, hidden_size=8192, num_heads=64, num_kv_heads=8,
        head_dim=128, intermediate_size=28672, vocab_size=32000)
    return dataclasses.replace(
        base, model=model,
        pruning=dataclasses.replace(base.pruning, head_keep=6),
        engine=dataclasses.replace(base.engine, max_batch_size=batch),
    ).validate()


def llama2_70b_rank_config(num_layers: int = 80, batch: int = 4):
    """One TP-4 rank's layer widths of Llama-2-70B as a one-card model
    (``sharded.local_config`` of ``llama2_70b_config`` over 4 model
    shards: hidden 8192, 16 query heads over 2 kv heads of 128,
    intermediate 7168, K1's <8, 128, false>), all 80 layers, ~34 GB of
    bf16 weights; head pruning off, as ``ShardedEngine`` drives no head
    mask clock."""
    base = llama2_70b_config(num_layers, batch)
    return dataclasses.replace(
        base, model=dataclasses.replace(base.model, num_heads=16,
                                        num_kv_heads=2,
                                        intermediate_size=7168),
        pruning=dataclasses.replace(base.pruning, enable_head_pruning=False,
                                    head_keep=0),
    ).validate()


def phase_70b_depth(dev) -> dict:
    """The four-card 70B run's depth on one card: ``llama2_70b_rank_config``
    (80 layers, batch 4, prompt 3072, capacity 4096, random bf16 weights
    from seed 0), its first decode window held against the plain versions
    by ``window_vs_plain`` at ``WINDOW_MEAN_TOL`` over the 16 steps the
    four-card run holds (``MESH_WINDOW``); K1 = 80 x 16."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    cfg = llama2_70b_rank_config()
    m = cfg.model
    name = f"Llama-2-70B TP-4 rank widths, {m.num_layers} layers, one card"
    t0 = time.perf_counter()
    params = tr.init_params(m, SEED, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"{name}: params {gb:.1f} GB bf16 in "
        f"{time.perf_counter() - t0:.1f} s")
    prompt = np.random.default_rng(SEED).integers(
        0, m.vocab_size, (cfg.engine.max_batch_size, SERVING_PROMPT))
    steps = min(MESH_WINDOW, gen.decode_window_steps(cfg))
    report = {}
    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    window_vs_plain(name, cfg, dev, params, prompt, None, steps,
                    report=report)
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    check(k1 == m.num_layers * steps, f"{name}: K1 launched {k1} times, "
          f"expected {m.num_layers * steps}")
    log(f"{name}: K1 launches {k1}, K2 launches {k2}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del params
    free()
    return dict(report, k1=k1, k2=k2, weights_gb=gb)


def pipeline_config(num_layers: int = 32, batch: int = SERVING_BATCH):
    """The serving settings at Llama-2-7B width with one budget and one
    pass-1 profile for every layer: a pipeline stage reads the cascade
    ratios, layer bits and capacity rungs of its own L/P layers (JAX's
    ``pipeline_local_config``; ROADMAP's reference quirks), so with
    per-layer tuples a staged run would be another configuration than
    the 1-rank run it is held against."""
    base = serving_config(num_layers)
    return dataclasses.replace(
        base, pruning=dataclasses.replace(base.pruning,
                                          cascade_layer_ratios=None),
        engine=dataclasses.replace(base.engine, max_batch_size=batch),
    ).validate()


def mesh_small_config():
    """A small f32-able model whose TP-2 shard keeps 2 kv heads of 64 (a
    128-lane width, so K1 launches on the card): 8 query heads over 4 kv
    heads, 2 layers, capacity 128 (prunes in prefill and decode)."""
    from spatten_tpu_torch.config import (
        EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
    )
    return SpAttenConfig(
        model=ModelConfig(vocab_size=512, hidden_size=512, num_layers=2,
                          num_heads=8, num_kv_heads=4, head_dim=64,
                          intermediate_size=512),
        pruning=PruningConfig(start_size=4, important_size=40,
                              recent_size=32, v_block_size=16),
        quant=QuantConfig(requant_threshold=0.1),
        engine=EngineConfig(max_batch_size=4, cache_capacity=128,
                            prefill_chunk=32),
    ).validate()


def toy_mesh_config(num_layers: int, num_kv_heads: int, group: int,
                    batch: int, base: str = "serving"):
    """The mesh phases' rehearsal model (on the CPU, in
    ``tests/test_torch_four_cards.py``): ``base``'s settings (the serving
    configuration, or ``pipeline_config``'s one budget for every layer)
    at head_dim 16, ``num_kv_heads`` kv heads of ``group``, vocab 512,
    capacity 128 (prompt prunes), 3/4 of the kv heads kept."""
    base_cfg = (serving_config if base == "serving" else pipeline_config)(
        num_layers)
    hq = num_kv_heads * group
    return dataclasses.replace(
        base_cfg,
        model=dataclasses.replace(
            base_cfg.model, vocab_size=512, hidden_size=hq * 16,
            num_heads=hq, num_kv_heads=num_kv_heads, head_dim=16,
            intermediate_size=256),
        pruning=dataclasses.replace(
            base_cfg.pruning, important_size=48, recent_size=16,
            v_block_size=16, head_keep=max(1, num_kv_heads * 3 // 4)),
        engine=dataclasses.replace(base_cfg.engine, max_batch_size=batch,
                                   cache_capacity=128, prefill_chunk=32),
    ).validate()


MESH_CONFIGS = {"serving": serving_config, "70b": llama2_70b_config,
                "pipeline": pipeline_config, "small": mesh_small_config,
                "toy": toy_mesh_config}


def mesh_engine(spec, mesh):
    from spatten_tpu_torch.parallel import PipelineEngine, ShardedEngine
    cfg = MESH_CONFIGS[spec["config"]](*spec.get("config_args", ()))
    if spec["engine"] == "sharded":
        return ShardedEngine(cfg, mesh)
    return PipelineEngine(cfg, mesh, microbatches=spec.get("micro", 1))


def mesh_steps(eng, params, prompt, tokens):
    """Teacher-forced run of an engine from an empty state: the prompt in
    chunks, then the decode steps fed ``tokens`` [B, n] (the global batch;
    a sharded rank feeds its rows).  Returns (the logits of the last
    prompt position and of each step, f32 [1 + n, B_rank, V] on the host,
    seconds of prefill and of decode)."""
    sharded = hasattr(eng, "rows")
    b = prompt.shape[0]
    rows = eng.rows(b) if sharded else slice(0, b)
    p = torch.as_tensor(prompt, device=eng.device)[rows].long()
    toks = torch.as_tensor(tokens, device=eng.device)[rows].to(torch.int32)
    state = eng.init_sharded_state(b)
    chunk = eng.cfg.engine.prefill_chunk
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
    sync()
    t0 = time.perf_counter()
    out = []
    for pos in range(0, p.shape[1], chunk):
        x = p[:, pos:pos + chunk]
        lg, state = (eng.prefill_step()(params, state, x) if sharded
                     else eng.step_fn(x.shape[1])(params, state, x))
    out.append(lg.float().cpu())
    sync()
    t1 = time.perf_counter()
    for i in range(toks.shape[1]):
        tok = toks[:, i]
        lg, state = (eng.decode_logits(params, state, tok) if sharded
                     else eng.step_fn(1)(params, state, tok[:, None]))
        out.append(lg.float().cpu())
    sync()
    return torch.stack(out), t1 - t0, time.perf_counter() - t1


class _Recorder:
    """Wraps an engine's step functions on the instance while ``generate``
    runs: keeps the logits of the last prompt position and of every decode
    step on the host, a copy of the state at the first decode step, the
    host clock and the transport's seconds over the first ``MESH_WINDOW``
    decode steps, and a device-time profile of the next few."""

    def __init__(self, eng, cuda: bool, events: bool = False):
        from torch.profiler import ProfilerActivity, profile
        self.eng, self.cuda, self.events = eng, cuda, events
        self.logits, self.snap, self.last, self.clock = [], None, None, {}
        self.steps = 0
        self.prof_steps = range(MESH_WINDOW, MESH_WINDOW + 4)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) if cuda \
            else None
        if hasattr(eng, "rows"):               # ShardedEngine
            prefill, decode = eng.prefill_logits, eng.decode_logits
            eng.prefill_logits = self._wrap(prefill, False)
            eng.decode_logits = self._wrap(decode, True)
        else:                                  # PipelineEngine
            step_fn = eng.step_fn
            eng.step_fn = lambda n: self._wrap(step_fn(n), n == 1)

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _wrap(self, fn, decode: bool):
        from spatten_tpu_torch.parallel import mesh as transport

        def call(params, state, x):
            if decode:
                i = self.steps
                if i == 0:
                    self.snap = state.clone()
                    self._sync()
                    transport.reset_counts(events=self.events)
                    self.clock["t0"] = time.perf_counter()
                    self.clock["prefill_s"] = (self.clock["t0"]
                                               - self.clock["start"])
                if i == MESH_WINDOW:
                    self._sync()
                    self.clock["window_s"] = (time.perf_counter()
                                              - self.clock["t0"])
                    # NCCL: CUDA events around each collective; gloo: the
                    # host clock around the transport
                    sec = (transport.device_seconds if self.events
                           else (lambda fn: fn.seconds))
                    self.clock["all_reduce_s"] = sec(transport.all_reduce)
                    self.clock["handoff_s"] = (sec(transport.send)
                                               + sec(transport.recv))
                    transport.reset_counts()
                if self.prof is not None and i == self.prof_steps.start:
                    self.prof.__enter__()
                if self.prof is not None and i == self.prof_steps.stop:
                    self._sync()
                    self.prof.__exit__(None, None, None)
                self.steps += 1
            lg, state = fn(params, state, x)
            self.last = state
            if decode or not self.logits:
                self.logits.append(lg.float().cpu())
            else:                                  # a later prompt chunk
                self.logits[0] = lg.float().cpu()
            return lg, state
        return call

    def device_ms(self, nccl: bool = False):
        """Device ms per profiled step of the kernels other than NCCL's
        (with ``nccl``: of NCCL's alone, which run on their own stream
        beside the others and spin while they wait for a peer)."""
        if self.prof is None:
            return None
        busy = sum(ev.self_device_time_total
                   for ev in self.prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA
                   and ev.key.startswith("nccl") == nccl)
        return busy / 1e3 / len(self.prof_steps) if busy else None

    def kernel_ms(self, key: str):
        """Device ms per call of the profiled kernels whose name holds
        ``key`` (K1's time at this rank's shard shape)."""
        if self.prof is None:
            return None
        evs = [ev for ev in self.prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA
               and key in ev.key]
        calls = sum(ev.count for ev in evs)
        return (sum(ev.self_device_time_total for ev in evs) / 1e3 / calls
                if calls else None)


def mesh_device(spec, rank: int) -> torch.device:
    """Where rank ``rank`` of a mesh phase runs: cuda:r (mod the cards)
    under NCCL, one card per rank; cuda:0 under gloo, every rank on one
    card; the CPU for ``device="cpu"``."""
    if spec.get("device", "cuda") != "cuda":
        return torch.device("cpu")
    if spec.get("backend", "gloo") == "nccl":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cuda", 0)


def mesh_replicas(eng, state, logits, tokens) -> dict:
    """What a rank holds that other ranks must hold bit for bit: {name:
    (the key its replicas share, tensor)}.  ShardedEngine: the logits,
    lengths and layer lengths over the "model" axis (one data shard's
    ranks), the head-mask slice over "data", the tokens and the requant
    count everywhere.  PipelineEngine: the logits (all-reduced over
    "pipe"), tokens and requant count everywhere, a stage's lengths over
    its "model" ranks (its head-mask slices are its ranks' own)."""
    c = eng.mesh.coords
    if hasattr(eng, "rows"):
        shard, heads = ("data", c["data"]), ("model", c["model"])
        lg = shard
    else:
        shard, heads = ("pipe", c["pipe"]), ("pipe", c["pipe"], c["model"])
        lg = ()
    return {"logits": (lg, logits), "tokens": ((), tokens),
            "lengths": (shard, state.lengths.cpu()),
            "layer_lengths": (shard, state.layer_lengths.cpu()),
            "head_mask": (heads, state.head_mask.cpu()),
            "requant_events": ((), state.requant_events.cpu())}


def mesh_rank(rank, world, spec):
    """One rank of a mesh phase (``run_mesh``).  With ``spec['forced']``
    (the 1-rank reference): the prompt, then the decode steps fed those
    tokens, logits kept.  Else the main path: ``generate`` with the K1/K2
    counts set to 0 just before it and read just after, its logits, host
    clock, collective seconds and a device-time profile recorded around
    the engine's step functions (``_Recorder``); then the first decode
    window again through the plain versions (``plain_versions``) from the
    state at its first decode step, fed the same tokens.  ``spec['replay']``: every forward call of ``generate``
    is first replayed on the CPU from a copy of its state
    (``kernel_checks``' rule: logits within ``CPU_REPLAY_LOGIT_TOL``)."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.config import MeshConfig
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import (
        gather_compact_rows, k2_takes,
    )
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.parallel import make_mesh
    cuda = spec.get("device", "cuda") == "cuda"
    nccl = spec.get("backend", "gloo") == "nccl"
    dev = mesh_device(spec, rank)
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    a, b = spec["mesh"]
    names = ("data", "model") if spec["engine"] == "sharded" else (
        "pipe", "model")
    mesh = make_mesh(MeshConfig(data=a, model=b, axis_names=names),
                     device=dev)
    out = dict(coords=mesh.coords, device=str(dev))
    if mesh.coords is None:
        return out
    dtype = torch.float32 if spec.get("f32") else torch.bfloat16
    t0 = time.perf_counter()
    eng = mesh_engine(spec, mesh)
    host_params = None
    if spec.get("f32"):
        # drawn on the host, so that the card's and the CPU's ranks (and
        # the CPU replay) hold the same weights
        params = eng.shard_params(tr.init_params(eng.cfg.model, SEED, dtype,
                                                 "cpu"))
        host_params = kc._to(params, torch.device("cpu"))
    else:
        params = eng.init_params(SEED, dtype)
    if cuda:
        torch.cuda.synchronize(dev)
    out["params_s"] = time.perf_counter() - t0
    m, lcfg = eng.cfg.model, eng.lcfg
    batch, plen, new = spec["batch"], spec["prompt_len"], spec["new"]
    prompt = np.random.default_rng(SEED).integers(0, m.vocab_size,
                                                  (batch, plen))
    # the prune schedule a rank's maybe_prune follows: every prompt chunk,
    # then every decode step (the engines prune step by step)
    lens, points = [0] * lcfg.model.num_layers, 0
    for pos in range(0, plen, lcfg.engine.prefill_chunk):
        layers, lens = gen.prune_schedule_step(
            lcfg, lens, min(lcfg.engine.prefill_chunk, plen - pos))
        points += len(layers)
    for _ in range(new):
        layers, lens = gen.prune_schedule_step(lcfg, lens, 1)
        points += len(layers)
    out["k2_expected"] = points if (cuda and k2_takes(m.head_dim)) else 0
    out["local_layers"] = lcfg.model.num_layers
    runs = []
    for micro in spec.get("micros", [1]):
        if hasattr(eng, "microbatches"):
            eng.microbatches = micro
        fused_decode_attention.launches = 0
        gather_compact_rows.launches = 0
        if spec.get("forced") is not None:
            logits, pre_s, dec_s = mesh_steps(eng, params, prompt,
                                              spec["forced"])
            runs.append(dict(micro=micro, k1=fused_decode_attention.launches,
                             k2=gather_compact_rows.launches,
                             logits=logits.numpy(),
                             prefill_s=pre_s, decode_ms=dec_s / new * 1e3,
                             device_ms=None, collective_ms=0.0,
                             handoff_ms=0.0, seconds=pre_s + dec_s))
            continue
        rec = _Recorder(eng, cuda, events=cuda and nccl)
        replay = kc._CpuReplay(host_params) if spec.get("replay") else None
        if replay is not None:
            replay.__enter__()
        try:
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = rec.clock["start"] = time.perf_counter()
            kw = {} if hasattr(eng, "microbatches") else {"eos_token_id": None}
            tokens = eng.generate(params, prompt, new, **kw)
            if cuda:
                torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
        finally:
            if replay is not None:
                replay.__exit__()
            for name in ("prefill_logits", "decode_logits", "step_fn"):
                eng.__dict__.pop(name, None)
        logits = torch.stack(rec.logits)          # [1 + new, B_rank, V]
        run = dict(micro=micro, seconds=seconds,
                   k1=fused_decode_attention.launches,
                   k2=gather_compact_rows.launches,
                   tokens=tokens.cpu().numpy(),
                   logits=logits.numpy(),
                   prefill_s=rec.clock["prefill_s"],
                   decode_ms=rec.clock["window_s"] / MESH_WINDOW * 1e3,
                   device_ms=rec.device_ms(),
                   nccl_ms=rec.device_ms(nccl=True),
                   k1_ms=rec.kernel_ms("fused_decode"),
                   collective_ms=rec.clock["all_reduce_s"] / MESH_WINDOW
                   * 1e3,
                   handoff_ms=rec.clock["handoff_s"] / MESH_WINDOW * 1e3,
                   timed_by="CUDA events" if rec.events else "host clock",
                   replicas=mesh_replicas(eng, rec.last, logits,
                                          tokens.cpu()))
        rec.last = None
        if replay is not None:
            # kernel_checks.check_server_against_cpu's rule: the single-
            # token calls within CPU_REPLAY_LOGIT_TOL; a prompt chunk
            # quantizes a row per token and layer, each of whose int8
            # roundings a last-bit projection difference may flip at half
            # a step, so its error is reported
            errs = replay.errors()
            run["replay_err"] = max((e for e, _, sh in errs if sh[1] == 1),
                                    default=0.0)
            run["replay_prefill_err"] = max(
                (e for e, _, sh in errs if sh[1] > 1), default=0.0)
            check(run["replay_err"] <= kc.CPU_REPLAY_LOGIT_TOL,
                  f"decode logits differ from the CPU replay's by "
                  f"{run['replay_err']:.3e}")
            chosen = torch.stack(replay.want)[-new - 1:-1]
            clear = kc._clear(chosen)
            sharded = hasattr(eng, "rows")
            rows = eng.rows(batch) if sharded else slice(0, batch)
            mine = torch.as_tensor(run["tokens"])[rows].T
            check(bool((chosen.argmax(-1) == mine)[clear].all()),
                  "greedy tokens differ from the CPU replay's where its "
                  "top-2 margin is clear")
            run["replay_clear"] = float(clear.float().mean())
        if spec.get("window", True):
            # the first window again through the plain versions, from the
            # state at the first decode step, fed the same tokens
            state = rec.snap
            sharded = hasattr(eng, "rows")
            rows = eng.rows(batch) if sharded else slice(0, batch)
            toks = torch.as_tensor(run["tokens"], device=dev)[rows].to(
                torch.int32)
            plain = []
            with plain_versions():
                for i in range(MESH_WINDOW):
                    tok = toks[:, i]
                    lg, state = (eng.decode_logits(params, state, tok)
                                 if sharded else
                                 eng.step_fn(1)(params, state, tok[:, None]))
                    plain.append(lg.float().cpu())
            lk = logits[1:MESH_WINDOW + 1]
            lp = torch.stack(plain)
            run["window_mean_err"] = float((lk - lp).abs().mean())
            run["window_argmax"] = float(
                (lk.argmax(-1) == lp.argmax(-1)).float().mean())
            run["window_by_step"] = (lk - lp).abs().mean(dim=(1, 2)).tolist()
            del state
        del rec
        runs.append(run)
        if cuda:
            torch.cuda.empty_cache()
    out["runs"] = runs
    if cuda:
        out["max_memory_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    tp = getattr(eng, "tp_group", None)
    if cuda and nccl and tp is not None and spec.get("forced") is None:
        out["all_reduce_us"] = all_reduce_alone_us(
            tp, (batch // mesh.shape.get("data", 1), 1, m.hidden_size),
            dtype, dev)
    return out


def all_reduce_alone_us(group, shape, dtype, dev, n: int = 50) -> float:
    """Device µs of one NCCL all-reduce of a decode step's activation
    ``shape`` over ``group`` with no compute around it: CUDA events
    around ``n`` back-to-back calls after a barrier (the time a
    collective costs when no peer is late)."""
    import torch.distributed as dist
    x = torch.zeros(shape, dtype=dtype, device=dev)
    for _ in range(5):
        dist.all_reduce(x, group=group)
    dist.barrier(group=group)
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        dist.all_reduce(x, group=group)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n * 1e3


def run_mesh(name, spec, world, device=None, backend=None) -> list:
    """Spawn ``world`` ranks of ``mesh_rank`` (gloo: on cuda:0, or the
    CPU; NCCL: rank r on cuda:r) and check each: K1 = local layers x
    tokens, K2 = the schedule's layer compactions, the first window
    against the plain versions, finite logits; and across the ranks,
    ``utils.debug.replicated_mismatch`` of every replicated tensor
    (``mesh_replicas``) exactly 0.0.  ``device`` and ``backend`` default
    to the spec's, else the card and gloo."""
    from spatten_tpu_torch.parallel import launch
    from spatten_tpu_torch.utils.debug import replicated_mismatch
    device = device or spec.get("device", "cuda")
    backend = backend or spec.get("backend", "gloo")
    spec = dict(spec, device=device, backend=backend)
    t0 = time.perf_counter()
    ranks = launch.spawn("chip_smoke:mesh_rank", world, spec,
                         timeout=spec.get("timeout", MESH_TIMEOUT),
                         backend=backend, threads=1)
    members = [r for r in ranks if r["coords"] is not None]
    replicas = {}
    for r in members:
        for i, run in enumerate(r["runs"]):
            for what, (key, t) in run.pop("replicas", {}).items():
                replicas.setdefault((i, what, key), []).append(
                    torch.as_tensor(t))
    shared = {k: v for k, v in replicas.items() if len(v) > 1}
    mismatch = max((replicated_mismatch(v) for v in shared.values()),
                   default=0.0)
    if shared:
        log(f"{name}: replicated_mismatch over {len(shared)} replica sets "
            f"({', '.join(sorted({k[1] for k in shared}))}) of "
            f"{len(members)} ranks: {mismatch}")
    check(mismatch == 0.0, f"{name}: replicated tensors differ between "
          f"ranks by {mismatch}")
    for r in members:
        r["replicated_mismatch"] = mismatch
    log(f"{name}: {len(members)} ranks ({backend}) in "
        f"{time.perf_counter() - t0:.1f} s")
    for r in members:
        for run in r["runs"]:
            k1 = run.get("k1_ms")
            log(f"  rank {r['coords']} on {r['device']} M={run['micro']}: "
                + ("teacher-forced" if "forced" in spec else "generate")
                + f" {run['seconds']:.2f} s: prefill {run['prefill_s']:.2f} "
                f"s, decode {run['decode_ms']:.2f} ms/step (host), device "
                + (f"{run['device_ms']:.3f}" if run["device_ms"] else
                   "not measured")
                + " ms/step"
                + (f" (+ NCCL kernels {run['nccl_ms']:.3f})"
                   if run.get("nccl_ms") else "")
                + f", all-reduce {run['collective_ms']:.3f} ms/step, "
                f"hand-off {run['handoff_ms']:.3f} ms/step ("
                + run.get("timed_by", "host clock") + ")"
                + (f"; one all-reduce alone {r['all_reduce_us']:.1f} us"
                   if r.get("all_reduce_us") else "") + "; K1 "
                + (f"{k1:.4f} ms a call, " if k1 else "")
                + f"{run['k1']} launches, K2 {run['k2']}; first window vs "
                "plain: mean "
                f"|diff| {run.get('window_mean_err', float('nan')):.2e}, "
                f"argmax {run.get('window_argmax', float('nan')):.3f}"
                + (" (by step " + " ".join(
                    f"{x:.4f}" for x in run["window_by_step"]) + ")"
                   if "window_by_step" in run else "")
                + f"; params {r['params_s']:.1f} s; peak memory "
                f"{r.get('max_memory_gb', 0):.1f} GB")
    for r in members:
        for run in r["runs"]:
            # K1 runs once per layer, step and microbatch
            expect = r["local_layers"] * spec["new"] * run["micro"]
            check(run["k1"] == (expect if device == "cuda" else 0),
                  f"{name} rank {r['coords']} M={run['micro']}: K1 launched "
                  f"{run['k1']} times, expected {expect}")
            check(run["k2"] == r["k2_expected"],
                  f"{name} rank {r['coords']}: K2 launched {run['k2']} "
                  f"times, expected {r['k2_expected']}")
            if "window_mean_err" in run:
                check(run["window_mean_err"] <= WINDOW_MEAN_TOL
                      and run["window_argmax"] >= WINDOW_ARGMAX_MIN,
                      f"{name} rank {r['coords']}: first window vs plain "
                      f"mean {run['window_mean_err']}, argmax "
                      f"{run['window_argmax']}")
            check(np.isfinite(run["logits"]).all(),
                  f"{name}: non-finite logits")
    return members


def gathered_logits(members, run_idx=0) -> np.ndarray:
    """The global [1 + n, B, V] logits of a mesh run from its ranks (the
    data shards' rows of model rank 0; a pipeline's rank 0 holds all)."""
    parts = []
    for r in members:
        c = r["coords"]
        if c.get("model", 0) == 0 and c.get("pipe", 0) == 0:
            parts.append((c.get("data", 0), r["runs"][run_idx]["logits"]))
    return np.concatenate([p for _, p in sorted(parts, key=lambda x: x[0])],
                          axis=1).astype(np.float32)


# Tensor and data parallelism in bf16, against the 1-rank run fed the same
# tokens: JAX's ShardedEngine departs from its own 1-rank run by a mean
# |logit diff| of 0.0493 at most and an argmax agreement of 0.838 at least
# over the last prompt position and the decode steps
# (tests/test_torch_sharded.py::test_bf16_tp_gap_within_jax: 4 layers, 8
# query heads over 4 kv heads, TP 4 and DP 2 x TP 2, on the CPU; the
# port's own gap there is 1.00x and 0.96x JAX's).  A card run may depart
# by TP_GAP_FACTOR times that: mean |diff| <= 0.0740, argmax >= 0.757.
JAX_TP_GAP_MEAN, JAX_TP_GAP_ARGMAX, TP_GAP_FACTOR = 0.0493, 0.838, 1.5
TP_MEAN_MAX = TP_GAP_FACTOR * JAX_TP_GAP_MEAN
TP_ARGMAX_MIN = 1.0 - TP_GAP_FACTOR * (1.0 - JAX_TP_GAP_ARGMAX)


def against_one_rank(name, members, spec, run_idx=0) -> dict:
    """The mesh run's logits against the same engine's 1-rank run on the
    same weights, fed the same tokens, with the same microbatches (on
    cuda:0, under the mesh run's backend).  A mesh whose ranks run the
    1-rank run's arithmetic (pipeline stages without TP or DP: the same
    GEMM shapes, bf16 activations handed over as they are) must give its
    logits exactly.  Tensor and data parallelism change the GEMMs' shapes
    and the order of the o_proj / down_proj sums, and SpAtten's discrete
    decisions (prompt prunes, requants, V-block keeps) amplify those
    last-bit differences, as they do in JAX's engine: such a run is held
    to JAX's measured departure times TP_GAP_FACTOR (TP_MEAN_MAX,
    TP_ARGMAX_MIN)."""
    run = members[0]["runs"][run_idx]
    micro = run["micro"]
    one = run_mesh(f"{name}, 1 rank", dict(spec, mesh=(1, 1),
                                           forced=run["tokens"],
                                           window=False, micros=[micro]), 1)
    got, want = gathered_logits(members, run_idx), gathered_logits(one)
    diff = np.abs(got - want)
    mean = float(diff.mean())
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    by_step = diff.mean(axis=(1, 2))
    exact = spec["engine"] == "pipeline" and spec["mesh"][1] == 1
    log(f"{name} M={micro}: logits vs the 1-rank run (same weights, same "
        f"tokens, {got.shape[0]} steps): mean |diff| {mean:.2e}, argmax "
        f"agreement {agree:.4f} ("
        + ("exact required" if exact else
           f"bound {TP_MEAN_MAX:.4f} / {TP_ARGMAX_MIN:.4f}")
        + f"); mean |logit| {float(np.abs(want).mean()):.4f}; mean by step "
        f"{' '.join(f'{x:.4f}' for x in by_step)}; identical: "
        f"{bool(mean == 0.0)}")
    if exact:
        check(mean == 0.0, f"{name} M={micro}: stages differ from the 1-rank"
              f" run (mean {mean})")
    else:
        check(mean <= TP_MEAN_MAX and agree >= TP_ARGMAX_MIN,
              f"{name} M={micro}: mean |diff| {mean:.4f}, argmax {agree:.4f} "
              f"against the 1-rank run, past the bound {TP_MEAN_MAX:.4f} / "
              f"{TP_ARGMAX_MIN:.4f}")
    return dict(mean_err=mean, argmax=agree, exact=exact,
                one_rank=mesh_summary(one))


def mesh_summary(members) -> dict:
    runs = [run for r in members for run in r["runs"]]
    return dict(
        ranks=len(members),
        decode_ms=max(run["decode_ms"] for run in runs),
        device_ms=max((run["device_ms"] or 0.0) for run in runs),
        k1_ms=max((run.get("k1_ms") or 0.0) for run in runs),
        collective_ms=max(run["collective_ms"] for run in runs),
        handoff_ms=max(run["handoff_ms"] for run in runs),
        max_memory_gb=max(r.get("max_memory_gb", 0.0) for r in members),
        replicated_mismatch=max(r.get("replicated_mismatch", 0.0)
                                for r in members),
        k1=sum(run["k1"] for run in runs), k2=sum(run["k2"] for run in runs))


def phase_sharded(dev) -> dict:
    """``ShardedEngine`` on ``serving_config(SHARDED_DEPTH)`` (Llama-2-7B
    width, random bf16 weights from seed 0), mesh data 2 x model 4: 8
    ranks, each [16, 4, 4096, 1024] planes in K1's <1, 128>; batch 8,
    prompt 3072, 32 new tokens; then its logits against the 1-rank run."""
    spec = dict(engine="sharded", config="serving", mesh=(2, 4),
                config_args=(SHARDED_DEPTH,), batch=SERVING_BATCH,
                prompt_len=SERVING_PROMPT, new=MESH_NEW_TOKENS)
    members = run_mesh("sharded Llama-2-7B 2x4", spec, 8)
    return dict(mesh_summary(members), vs_one_rank=against_one_rank(
        "sharded Llama-2-7B 2x4", members, spec))


def phase_sharded_70b(dev) -> dict:
    """``ShardedEngine`` at Llama-2-70B's widths, depth 4 of 80 (the
    one-card run's time), mesh 1 x 8: each rank 1 kv head of group 8, K1's
    <8, 128> in 4 CTAs at batch 4; capacity 4096, prompt 3072, 32 new
    tokens -- the shard shape of Llama-2-70B served over TP 8; then
    against the 1-rank run."""
    spec = dict(engine="sharded", config="70b", config_args=(4, 4),
                mesh=(1, 8), batch=4, prompt_len=SERVING_PROMPT,
                new=MESH_NEW_TOKENS)
    members = run_mesh("sharded Llama-2-70B widths 1x8", spec, 8)
    return dict(mesh_summary(members), vs_one_rank=against_one_rank(
        "sharded Llama-2-70B widths 1x8", members, spec))


def phase_pipeline(dev, backend="gloo", device="cuda", shrink=None,
                   num_layers: int = 32) -> dict:
    """``PipelineEngine`` on Llama-2-7B (``pipeline_config(num_layers)``),
    4 stages of num_layers / 4 layers, batch 8, M = 1 then M = 2, each
    against the 1-rank run
    with the same microbatches (equal logits); then pipe 2 x model 2 at
    half that depth, batch 4, M = 2, against its 1-rank run.  ``backend``: gloo
    (every rank on cuda:0) or NCCL (rank r on cuda:r, the hand-offs card
    to card).  ``shrink``: a rehearsal's spec -> spec at a toy size."""
    where = " on 4 cards" if backend == "nccl" else ""
    shrink = shrink or (lambda spec: spec)
    spec = shrink(dict(engine="pipeline", config="pipeline", mesh=(4, 1),
                       config_args=(num_layers, SERVING_BATCH),
                       batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                       new=MESH_NEW_TOKENS, micros=[1, 2], backend=backend,
                       device=device))
    members = run_mesh("pipeline Llama-2-7B 4 stages" + where, spec, 4)
    pp4 = dict(mesh_summary(members), per_rank=rank_rows(members),
               vs_one_rank=[against_one_rank("pipeline 4 stages" + where,
                                             members, spec, i)
                            for i in range(2)])
    spec = shrink(dict(engine="pipeline", config="pipeline",
                       config_args=(num_layers // 2, 4), mesh=(2, 2), batch=4,
                       prompt_len=SERVING_PROMPT, new=MESH_NEW_TOKENS,
                       micros=[2], backend=backend, device=device))
    members = run_mesh(f"pipeline Llama-2-7B depth {num_layers // 2}, "
                       "2 stages x TP 2" + where, spec, 4)
    return dict(pp4=pp4, pp2_tp2=dict(
        mesh_summary(members), per_rank=rank_rows(members),
        vs_one_rank=against_one_rank("pipeline 2 stages x TP 2" + where,
                                     members, spec)))


def rank_rows(members) -> list:
    """Each rank's numbers of a mesh run, for the record."""
    keys = ("decode_ms", "device_ms", "nccl_ms", "k1_ms", "collective_ms",
            "handoff_ms", "prefill_s", "timed_by", "k1", "k2",
            "window_mean_err", "window_argmax")
    return [dict(coords=r["coords"], device=r["device"],
                 max_memory_gb=r.get("max_memory_gb"),
                 all_reduce_us=r.get("all_reduce_us"),
                 runs=[{k: run.get(k) for k in keys} for run in r["runs"]])
            for r in members]


# ------------------------------------------------------------ four cards
# ``python3 chip_smoke.py --cards 4``: the multi-card slice over NCCL, one
# card per rank (``main_cards``).
CARDS_70B_LAYERS = 80


def phase_cards_sharded(dev, cards: int, backend="nccl", device="cuda",
                        shrink=None) -> dict:
    """``ShardedEngine`` at ``serving_config()`` (Llama-2-7B, 32 layers,
    batch 8, prompt 3072, 32 new tokens) over NCCL at data 1 x model 4
    (8 kv heads a card) and 2 x 2 (16 kv heads and 4 rows a card), each
    against its 1-rank run on cuda:0 at the TP bound.  ``shrink``: a
    rehearsal's spec -> spec at a toy size."""
    shrink = shrink or (lambda spec: spec)
    out = {}
    for mesh in ((1, cards), (2, cards // 2)):
        name = f"sharded Llama-2-7B {mesh[0]}x{mesh[1]} on {cards} cards"
        spec = shrink(dict(engine="sharded", config="serving", mesh=mesh,
                           batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                           new=MESH_NEW_TOKENS, backend=backend,
                           device=device))
        members = run_mesh(name, spec, cards)
        out[f"{mesh[0]}x{mesh[1]}"] = dict(
            mesh_summary(members), per_rank=rank_rows(members),
            vs_one_rank=against_one_rank(name, members, spec))
        free()
    return out


def phase_cards_70b(dev, cards: int, backend="nccl", device="cuda",
                    shrink=None) -> dict:
    """``ShardedEngine`` at Llama-2-70B's widths and all 80 layers over
    TP 4 (``llama2_70b_config(80, batch=4)``, capacity 4096, prompt 3072,
    32 new tokens): each card holds 2 kv heads of group 8 (K1's <8, 128,
    false> on 8 CTAs) and draws its shard of the weights on itself
    (``init_params(keep=...)``, ~35 GB).  No card holds the 1-rank run,
    so the link to a reference, run first, is the same mesh at depth 8
    against its 1-rank run on cuda:0."""
    shrink = shrink or (lambda spec: spec)
    spec = dict(engine="sharded", config="70b", config_args=(8, 4),
                mesh=(1, cards), batch=4, prompt_len=SERVING_PROMPT,
                new=MESH_NEW_TOKENS, backend=backend, device=device)
    name = f"sharded Llama-2-70B depth 8 1x{cards}"
    members = run_mesh(name, shrink(spec), cards)
    link = dict(mesh_summary(members), per_rank=rank_rows(members),
                vs_one_rank=against_one_rank(name, members, shrink(spec)))
    free()
    spec = dict(spec, config_args=(CARDS_70B_LAYERS, 4), timeout=900)
    name = f"sharded Llama-2-70B {CARDS_70B_LAYERS} layers 1x{cards}"
    members = run_mesh(name, shrink(spec), cards)
    return {"depth 8": link, "80 layers": dict(
        mesh_summary(members), per_rank=rank_rows(members),
        local_layers=members[0]["local_layers"])}


def cli_mesh_rank(rank, world, ckpt, turns, argv):
    """The CLI's mesh path through the library, for ``phase_cards_cli``:
    the checkpoint through ``hf_loader``, the CLI's configuration on a
    1 x ``world`` mesh, ``ShardedEngine.generate`` per turn from a fresh
    state (greedy); the replies and K1/K2 launches."""
    import run_spatten_gpu as cli
    from spatten_tpu_torch.config import MeshConfig
    from spatten_tpu_torch.models import hf_loader
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    from spatten_tpu_torch.parallel import ShardedEngine, make_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    mcfg, params = hf_loader.load_pretrained(ckpt, device="cpu")
    with open(f"{ckpt}/config.json") as fh:
        eos = json.load(fh)["eos_token_id"]
    cfg = cli.build_config(cli.parse_args(argv), mcfg)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, mesh=MeshConfig(data=1, model=world)))
    eng = ShardedEngine(cfg, make_mesh(cfg.engine.mesh, device=dev))
    params = eng.shard_params(params)
    fused_decode_attention.launches = gather_compact_rows.launches = 0
    replies = []
    for t in turns:
        toks = eng.generate(params, torch.tensor([t]), CLI_NEW,
                            eos_token_id=eos).cpu()
        replies.append([x for x in toks[0].tolist() if x != eos])
    return dict(device=str(dev), replies=replies,
                k1=fused_decode_attention.launches,
                k2=gather_compact_rows.launches,
                local_layers=eng.lcfg.model.num_layers)


def phase_cards_cli(dev, cards: int) -> dict:
    """``run_spatten_gpu.py --mesh_model 4`` under ``python -m
    torch.distributed.run --nproc_per_node 4`` (NCCL, one card a rank) on
    the random ``CLI_LAYERS``-layer Llama-2-7B-width checkpoint of
    ``phase_cli`` with its two turns of ids: exit 0, and its replies equal
    ``ShardedEngine.generate`` on the same checkpoint and mesh called in
    process on each rank (``cli_mesh_rank``), whose K1 launches are
    local layers x tokens a turn."""
    import shutil
    import tempfile
    from pathlib import Path
    import run_spatten_gpu as cli
    from spatten_tpu_torch.parallel import launch
    root = Path(tempfile.mkdtemp(prefix="spatten-cli-cards-"))
    try:
        hf = write_random_llama(root / "ckpt", CLI_LAYERS)
        rng = np.random.default_rng(SEED)
        turns = [rng.integers(3, hf["vocab_size"], n).tolist()
                 for n in CLI_TURNS]
        (root / "prompts.jsonl").write_text(json.dumps({"ids": turns}))
        argv = ["--model_path", str(root / "ckpt"), "--prompts",
                str(root / "prompts.jsonl"), "--max_new_tokens",
                str(CLI_NEW), "--mesh_model", str(cards)]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(cards),
             str(Path(cli.__file__).resolve()), *argv],
            capture_output=True, text=True, timeout=600)
        cli_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"run_spatten_gpu.py --mesh_model "
              f"{cards} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-4000:]}")
        got = [json.loads(line.split("reply ids: ", 1)[1])
               for line in proc.stdout.splitlines()
               if line.startswith("reply ids: ")]
        ranks = launch.spawn("chip_smoke:cli_mesh_rank", cards,
                             str(root / "ckpt"), turns, argv,
                             backend="nccl", timeout=600)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    want = ranks[0]["replies"]
    check(all(r["replies"] == want for r in ranks),
          "cli: the ranks' in-process replies differ")
    check(got == want and len(got) == len(turns),
          "cli: replies of the CLI on 4 cards differ from "
          "ShardedEngine.generate's")
    for r in ranks:
        check(r["k1"] == r["local_layers"] * CLI_NEW * len(turns),
              f"cli on {r['device']}: K1 launched {r['k1']} times")
    log(f"cli on {cards} cards: run_spatten_gpu.py --mesh_model {cards} "
        f"under torch.distributed.run (NCCL) exit 0 in {cli_s:.1f} s; "
        f"replies ({sum(map(len, got))} ids over {len(got)} turns) equal "
        f"ShardedEngine.generate on cards "
        f"{', '.join(r['device'] for r in ranks)}; K1 "
        f"{[r['k1'] for r in ranks]}, K2 {[r['k2'] for r in ranks]}")
    return dict(seconds=cli_s, k1=sum(r["k1"] for r in ranks),
                k2=sum(r["k2"] for r in ranks))


CARDS_PHASES = ("sharded", "70b", "pipeline", "cli", "split-k")
# one card, ``--phases``: the phases each name runs
ONE_CARD_PHASES = {"server": (server_small_check, phase_server),
                   "latent": (phase_k1_latent, phase_grouped_gemm,
                              phase_server_latent)}


def main_cards(cards: int, only=None) -> int:
    """``--cards N``: only the multi-card phases, rank r on cuda:r under
    NCCL: ``phase_cards_sharded``, ``phase_cards_70b``, ``phase_pipeline``
    (NCCL), ``phase_cards_cli`` and ``phase_split_k`` over the N cards
    (``only``: those of CARDS_PHASES named).  Each phase's failure is
    printed and the others still run; any failure fails the run, which
    then prints no result."""
    import traceback
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cards:
        print(f"chip_smoke --cards {cards}: {torch.cuda.device_count()} "
              f"card(s) visible", file=sys.stderr)
        return 1
    import spatten_tpu_torch  # noqa: F401  (fails outside the repository)
    from spatten_tpu_torch import kernels
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[:cards]
    log(f"cards: {'; '.join(smi)}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                          text=True).stdout.rstrip()
    log("nvidia-smi topo -m:\n" + topo)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, NCCL {torch.cuda.nccl.version()}")
    t_start = time.perf_counter()
    secs, _ = kernels.build_all(force=True)
    log(f"built in {secs:.1f} s (once, before the ranks start)")
    devices = [torch.device("cuda", i) for i in range(cards)]
    phases = dict(zip(CARDS_PHASES, (
        lambda: phase_cards_sharded(dev, cards),
        lambda: phase_cards_70b(dev, cards),
        lambda: phase_pipeline(dev, backend="nccl"),
        lambda: phase_cards_cli(dev, cards),
        lambda: phase_split_k(dev, devices=devices))))
    results, failed = {}, []
    for name, fn in phases.items():
        if only and name not in only:
            continue
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:                      # printed; the run fails
            log(f"PHASE FAILED: {name}\n{traceback.format_exc()}")
            failed.append(name)
        log(f"[{name}: {time.perf_counter() - t0:.1f} s]")
        free()
    log(f"total {time.perf_counter() - t_start:.0f} s")
    if failed:
        log(f"failed phases: {failed}")
        return 1
    print(json.dumps({"cards": results}, default=str), flush=True)
    print("; ".join(smi), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mesh_small_check(dev) -> dict:
    """An f32 run at small width, DP 2 x TP 2 (2 kv heads of 64 a shard,
    so K1 launches), through ``ShardedEngine.generate``: its tokens equal
    the same ranks' run on the CPU (gloo), and every decode step of the
    card's run, replayed on the CPU from a copy of its state (its
    all-reduces over the same gloo groups), gives logits within
    ``CPU_REPLAY_LOGIT_TOL`` and the CPU's greedy token where its top two
    are clear (``kernel_checks``' rules for the server: two free runs
    drift apart once an int8 rounding at half a step flips, so the free
    runs' logits and the prompt chunks' replay errors are printed)."""
    from spatten_tpu_torch import kernel_checks as kc
    spec = dict(engine="sharded", config="small", mesh=(2, 2), batch=4,
                prompt_len=200, new=24, f32=True, window=False, replay=True)
    card = run_mesh("small f32 2x2 on the card", spec, 4)
    cpu = run_mesh("small f32 2x2 on the CPU", dict(spec, replay=False), 4,
                   device="cpu")
    same = bool(np.array_equal(card[0]["runs"][0]["tokens"],
                               cpu[0]["runs"][0]["tokens"]))
    free = float(np.abs(gathered_logits(card) - gathered_logits(cpu)).max())
    err = max(r["runs"][0]["replay_err"] for r in card)
    pre = max(r["runs"][0]["replay_prefill_err"] for r in card)
    log(f"small f32 2x2: tokens equal the CPU run's: {same}; each decode "
        f"step vs its CPU replay: logits max |diff| {err:.2e} (tolerance "
        f"{kc.CPU_REPLAY_LOGIT_TOL}; prompt chunks {pre:.2e}), top-2 clear "
        f"in {min(r['runs'][0]['replay_clear'] for r in card):.3f} of rows;"
        f" free runs' logits max |diff| {free:.2e}")
    check(same, "small f32 2x2: tokens differ from the CPU run")
    return dict(k1=sum(r["runs"][0]["k1"] for r in card),
                k2=sum(r["runs"][0]["k2"] for r in card), replay_err=err,
                replay_prefill_err=pre, free_run_err=free)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Drive the port on the card.")
    ap.add_argument("--cards", type=int, default=1,
                    help="1 (default): every one-card phase; N > 1: only "
                         "the multi-card phases, one card per rank (NCCL)")
    ap.add_argument("--phases", nargs="+",
                    choices=CARDS_PHASES + tuple(ONE_CARD_PHASES),
                    help="with --cards: only these multi-card phases (a "
                         "four-card call costs four times its minutes); "
                         f"on one card: only {sorted(ONE_CARD_PHASES)}")
    args = ap.parse_args(argv)
    allowed = CARDS_PHASES if args.cards > 1 else tuple(ONE_CARD_PHASES)
    if any(p not in allowed for p in args.phases or ()):
        ap.error(f"--phases with --cards {args.cards}: one of {allowed}")
    if args.cards > 1:
        return main_cards(args.cards, args.phases)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import spatten_tpu_torch  # noqa: F401  (fails outside the repository)

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    if args.phases:
        return run_one_card_phases(dev, args.phases)
    t_start = time.perf_counter()
    corpus_proc = extract_corpus_in_background()
    try:
        return run_one_card(dev, smi, t_start, corpus_proc)
    finally:
        if corpus_proc[0].poll() is None:
            corpus_proc[0].kill()
            corpus_proc[0].wait()


def run_one_card_phases(dev, names) -> int:
    """``--phases`` on one card: build the kernels, then run only the
    phases ``ONE_CARD_PHASES`` gives those names, and print their results
    as the last line."""
    from spatten_tpu_torch import kernels
    secs, _ = kernels.build_all()
    log(f"built in {secs:.1f} s")
    results = {}
    for name in names:
        for fn in ONE_CARD_PHASES[name]:
            t0 = time.perf_counter()
            results[fn.__name__] = fn(dev)
            log(f"[{fn.__name__}: {time.perf_counter() - t0:.1f} s]")
    print(json.dumps({"ok": True, "phases": results}, default=str),
          flush=True)
    return 0


def run_one_card(dev, smi: str, t_start: float, corpus_proc) -> int:
    """Every one-card phase, in order (``main`` without ``--cards``)."""
    from spatten_tpu_torch import kernels
    from spatten_tpu_torch.perf import H100_SXM
    secs, reports = kernels.build_all(force=True)
    log(f"built {sorted(reports)} in {secs:.1f} s")
    spills = {}
    for name, rep in reports.items():
        inst = None
        for line in rep.splitlines():
            if "Function properties for" in line:
                # the instance's template arguments: for K1, <G, D,
                # whether the score plane is in shared memory>
                fn = line.split("for", 1)[1].strip()
                args = [("true" if a == "b1" else "false") if a[0] == "b"
                        else a[1:]
                        for a in re.findall(r"L([ib]\d+)E", fn)]
                inst = "<" + ", ".join(args) + ">" if args else fn
                log(f"  {name}: {inst}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")
                m = re.search(r"(\d+) bytes spill stores", line)
                if m:
                    spills[(name, inst)] = int(m.group(1))
    check(spills.get(("fused_decode", "<1, 128, true>")) == 0,
          "K1 <1, 128, true> (the main path's instance) spills registers")
    spilled = [i for (n, i), v in spills.items()
               if n == "fused_decode" and v]
    check(not spilled, f"K1 instances {spilled} spill registers")

    phase_s = {}

    def timed(fn, *args, **kw):
        """Run one phase (a path: ``run_path`` and its name) and print
        its seconds."""
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        name = args[0] if fn is run_path else fn.__name__
        phase_s[name] = time.perf_counter() - t0
        log(f"[{name}: {phase_s[name]:.1f} s]")
        return out

    k1_pr1 = timed(phase_k1_slice1, slice_config(), dev)
    k1_srv = timed(phase_k1_serving, dev)
    k1_llama = timed(phase_k1_llama32, dev)
    k1_flags_res = timed(phase_k1_flags, dev)
    k1_groups = timed(phase_k1_groups, dev)
    k1_dims = timed(phase_k1_head_dims, dev)
    k1_caps = timed(phase_k1_capacity, dev)
    k1_dev_scores = timed(phase_k1_device_scores, dev)
    k1_wide = timed(phase_k1_wide_groups, dev)
    k1_long = timed(phase_k1_long_windows, dev)
    k1_wide_dims = timed(phase_k1_wide_head_dims, dev)
    k1_shards = timed(phase_k1_shard_shapes, dev)
    k1_round = timed(phase_k1_rounding, dev)
    k1_skip = timed(phase_k1_skip_append, dev)
    k1_latent = timed(phase_k1_latent, dev)
    k2_pr1 = timed(phase_k2, dev, b=4, cap=1024, hkv=32, d=128,
                   keep_max=772, window=1024,
                   lengths=[1024, 1024, 900, 1000], triggered=[1, 0, 1, 1],
                   keep_count=[772, 772, 600, 772])
    # serving shapes: a deep layer (rung 2048, keep 976) at a decode prune
    k2_srv = timed(phase_k2, dev, b=SERVING_BATCH, cap=SERVING_CAP, hkv=32,
                   d=128, keep_max=976, window=2048,
                   lengths=[2048, 2047, 2000, 2048, 1990, 2048, 2048, 2048],
                   triggered=[1, 1, 1, 0, 1, 1, 1, 1],
                   keep_count=[976, 976, 976, 976, 600, 976, 976, 976])
    split = timed(phase_split_k, dev)
    grouped = timed(phase_grouped_gemm, dev)
    probe = timed(phase_launch_probe, dev)
    timed(small_reference_check, dev)
    gate = timed(phase_gate, dev)
    small_server = timed(server_small_check, dev)
    small_mesh = timed(mesh_small_check, dev)
    log(f"kernel phases done at {time.perf_counter() - t_start:.0f} s")

    pr1 = timed(run_path, "first slice (depth 8)", slice_config(8), dev,
                batch=4, prompt_len=1152, new_tokens=128)
    del pr1["params"], pr1["res"]
    free()
    serving = timed(run_path, "serving", serving_config(), dev,
                    batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                    new_tokens=128, window_check=True)
    params = serving.pop("params")
    del serving["res"]
    free()
    # the dense and parity paths at depth 8 (with the profile path's 8):
    # the multi-card phases below take the time their full depth took
    dense = timed(run_path, "dense (depth 8)", dense_config(EARLY_DEPTH),
                  dev, batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                  new_tokens=64, params=dict(params, layers={
                      k: v[:EARLY_DEPTH] for k, v in params["layers"].items()}))
    del params, dense["params"], dense["res"]
    free()
    prof = timed(run_path, "profile 4,4,6,6,8 (depth 8)", profile_config(8),
                 dev, batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                 new_tokens=64)
    lr = prof["res"].layer_requants.tolist()
    bits = profile_config(8).quant.resolved_layer_bits(8)
    check(all((n == 0) == (b == 8) for n, b in zip(lr, bits)),
          f"requant events by layer {lr} for bits {bits}: only the 4- and "
          "6-bit layers may (and here do) requantize")
    log(f"profile: requant events by layer {lr} for bits {list(bits)}")
    del prof["params"], prof["res"]
    free()
    log(f"dense-int8 baseline decode {dense['tok_s']:.1f} tok/s vs serving "
        f"{serving['tok_s']:.1f} tok/s (batch {SERVING_BATCH}; printed, no "
        f"claim)")
    parity = timed(run_path, "parity (depth 8)", parity_config(EARLY_DEPTH),
                   dev,
                   batch=PARITY_BATCH, prompt_len=PARITY_PROMPT,
                   new_tokens=128, window_check=True)
    del parity["params"], parity["res"]
    free()
    llama = timed(run_path, "Llama-3.2-3B", llama32_3b_config(), dev,
                  batch=SERVING_BATCH, prompt_len=SERVING_PROMPT,
                  new_tokens=LLAMA32_NEW_TOKENS, window_check=True)
    del llama["params"], llama["res"]
    free()
    openllama = timed(run_path, "OpenLLaMA-3B", openllama_3b_config(), dev,
                      batch=SERVING_BATCH, prompt_len=OPENLLAMA_PROMPT,
                      new_tokens=OPENLLAMA_NEW_TOKENS, window_check=True)
    del openllama["params"], openllama["res"]
    free()
    depth70 = timed(phase_70b_depth, dev)
    server = timed(phase_server, dev)
    server_latent = timed(phase_server_latent, dev)
    trace = timed(phase_trace, dev)
    replay = timed(phase_replay, dev, trace)
    supervised = timed(phase_supervised, dev)
    cli = timed(phase_cli, dev)
    debug_hook = timed(phase_debug_hook, dev)
    ppl = timed(phase_ppl, dev, corpus_proc=corpus_proc)
    hbm = timed(phase_hbm, dev)
    bench = timed(phase_bench, dev)
    bench_tools = timed(phase_bench_tools, dev)
    sharded = timed(phase_sharded, dev)
    sharded_70b = timed(phase_sharded_70b, dev)
    pipeline = timed(phase_pipeline, dev, num_layers=MESH_DEPTH)
    # the cost model's per-step overhead: the serving path's host time per
    # decode step beyond its device time
    log(f"cost model step overhead, serving path: "
        f"{serving['idle'] * serving['step_ms'] * 1e3:.1f} us per step "
        f"(host {serving['step_ms']:.3f} ms, idle {serving['idle']:.3f}); "
        f"the card preset holds {H100_SXM.step_overhead_us} us")
    log(f"total {time.perf_counter() - t_start:.0f} s")

    paths = {"serving": serving, "first slice": pr1, "dense": dense,
             "profile": prof, "parity": parity, "Llama-3.2-3B": llama,
             "OpenLLaMA-3B": openllama, "server": server}
    k1_by_path = {k: v["k1"] for k, v in paths.items()}
    k1_by_path.update({"server, small f32": small_server["k1"],
                       "server, DeepSeek-V2-Lite widths, 2 layers":
                       server_latent["k1"],
                       "trace": trace["k1"], "supervised": supervised["k1"],
                       "cli": cli["k1"], "debug hook": debug_hook["k1"],
                       "70B TP-4 rank widths, 80 layers": depth70["k1"],
                       "ppl gpt2s": sum(ppl[k]["k1"] for k in PPL_RUNS),
                       "sharded 2x4": sharded["k1"],
                       "sharded 70B widths 1x8": sharded_70b["k1"],
                       "pipeline 4 stages (M=1, M=2)": pipeline["pp4"]["k1"],
                       "pipeline 2x2": pipeline["pp2_tp2"]["k1"],
                       "sharded small f32 2x2": small_mesh["k1"],
                       "bench 4096x16": bench["k1"],
                       "bench tools": bench_tools["k1"]})
    k2_by_path = {k: v["k2"] for k, v in paths.items()}
    k2_by_path.update({"server, small f32": small_server["k2"],
                       "supervised": supervised["k2"], "cli": cli["k2"],
                       "debug hook": debug_hook["k2"],
                       "70B TP-4 rank widths, 80 layers": depth70["k2"],
                       "ppl gpt2s": sum(ppl[k]["k2"] for k in PPL_RUNS),
                       "sharded 2x4": sharded["k2"],
                       "sharded 70B widths 1x8": sharded_70b["k2"],
                       "pipeline 4 stages (M=1, M=2)": pipeline["pp4"]["k2"],
                       "pipeline 2x2": pipeline["pp2_tp2"]["k2"],
                       "sharded small f32 2x2": small_mesh["k2"],
                       "bench 4096x16": bench["k2"]})
    k1_srv["max_abs_err"] = max(
        [k1_srv["max_abs_err"], k1_flags_res["max_abs_err"],
         k1_llama["max_abs_err"], k1_groups["max_abs_err"],
         k1_dims["max_abs_err"], k1_caps["max_abs_err"],
         k1_wide["max_abs_err"], k1_long["max_abs_err"],
         k1_wide_dims["max_abs_err"], k1_shards["max_abs_err"]]
        + [r["max_abs_err"] for r in k1_dev_scores.values()]
        + [r["max_abs_err"] for r in k1_latent.values()])
    kernels_out = [
        dict(name="fused_decode_attention", route="cuda",
             source="spatten_tpu_torch/csrc/fused_decode.cu",
             replaces="spatten_tpu/ops/fused_decode.py:2319",
             launches=sum(k1_by_path.values()), **k1_srv,
             launches_by_path=k1_by_path,
             first_slice=dict(k1_pr1, launches=pr1["k1"]),
             parity=dict(k1_flags_res["parity"], launches=parity["k1"]),
             llama32_3b=dict(k1_llama, launches=llama["k1"], library_ms=None),
             split_k={k: dict(v) for k, v in split.items()},
             device_scores=k1_dev_scores, head_dims=k1_dims["cases"],
             capacity=k1_caps["cases"],
             wide_groups=dict(k1_wide["cases"], gate_model_launches=gate[
                 GQA16_NAME]["k1"]),
             long_windows=k1_long["cases"],
             wide_head_dims=k1_wide_dims["cases"],
             shard_shapes=k1_shards["cases"],
             stages_exact={rung: {k: f"{v['exact']}/{v['total']}"
                                  for k, v in rep.items() if "exact" in v}
                           for rung, rep in k1_round.items()},
             skip_append=k1_skip,
             latent=dict(k1_latent, server=server_latent),
             bench=dict(point=bench["point"], window=bench["window"],
                        tools=bench_tools["counts"]),
             meshes={"sharded 2x4": sharded, "sharded 70B widths 1x8":
                     sharded_70b, "pipeline": pipeline}),
        dict(name="gather_compact_rows", route="cuda",
             source="spatten_tpu_torch/csrc/compact_gather.cu",
             replaces="spatten_tpu/ops/compact_gather.py:335",
             launches=sum(k2_by_path.values()), **k2_srv,
             launches_by_path=k2_by_path,
             first_slice=dict(k2_pr1, launches=pr1["k2"])),
    ]
    kernels_out += probe_entries(probe, serving["probe_launches"])
    out = {"kernels": kernels_out, "grouped_gemm": grouped}
    log("library_ms: fused_decode_attention has no single PyTorch call "
        "computing its function (append + 4/6/8-bit scoring + requant + "
        "importance + V top-k + 8-bit P·V); gather_compact_rows is timed "
        "against two torch.gather calls (K and V planes, out of place); "
        "P1 against torch.add(x, 1.0), P2 against torch.add(x, 1.0, "
        "out=o), P3 against plane[:256].sum(), P4 against "
        "plane[:8].add_(1), P5 against torch.add(x, s[0], out=o) (the "
        "scalar read on the card; library_host_scalar_ms: "
        "torch.add(x, 1.0)); P2-P5's ms, library_ms and floor_ms are "
        "medians of interleaved repeats in one call, floor_ms an empty "
        "kernel's launch.  The probes' launches on the paths are 0 (they "
        "are off every path); probe_launches counts their own phase")
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
