"""Configuration tree for the PyTorch/CUDA port of the spatten-tpu engine.

This is the port's own copy of ``spatten_tpu/config.py``: the port imports
nothing of the JAX package.  Field names are identical, so one dict builds
both trees.  ``EngineConfig.use_pallas`` reads as "use the hand-written
kernels" here (the CUDA kernels under ``spatten_tpu_torch/csrc``).

The reference scatters configuration over five layers (SURVEY.md §5: argparse,
Java system properties, the compile-time `SpAttenConfig` case class at
spatten_hardware/.../SpAtten.scala:9-49, ramulator yaml, and per-request
metadata).  Here it is a single frozen-dataclass tree; the reference's
"policy is data, not config" insight is kept: per-layer / per-step pruning and
quantization *decisions* travel as arrays inside the decode state (see
`spatten_tpu.engine.policy`), while this module holds the static knobs.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of a served transformer (Llama / GPT-2 families)."""

    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32          # < num_heads => GQA
    head_dim: int = 128
    intermediate_size: int = 11008
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    model_type: str = "llama"        # "llama" | "gpt2"
    activation: str = "silu"         # "silu" (llama) | "gelu" (gpt2)
    tie_word_embeddings: bool = False
    # GPT-2 style knobs
    use_qkv_bias: bool = False
    use_mlp_bias: bool = False
    use_attn_scale_by_layer: bool = False  # gpt2 scale_attn_by_inverse_layer_idx
    layernorm_kind: str = "rmsnorm"  # "rmsnorm" (llama) | "layernorm" (gpt2)
    use_abs_pos_emb: bool = False    # gpt2 learned positions instead of RoPE

    @property
    def q_heads_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    # --- the cache geometry: what one cached row of a token holds.  The
    # state's planes, K1's call, prefill, compaction and the head mask
    # read these, never ``num_kv_heads`` / ``head_dim`` directly, so that
    # a latent-cache model (``DeepseekV2Config``) lays its rows out as
    # one cached head.  Properties, not fields: the llama and GPT-2 trees
    # keep exactly their fields.
    @property
    def latent(self) -> bool:
        """Whether the cache holds a latent row (MLA) rather than K/V
        heads."""
        return False

    @property
    def cache_heads(self) -> int:
        """Cached heads of a token: the kv heads."""
        return self.num_kv_heads

    @property
    def cache_dim(self) -> int:
        """Lanes of one cached head row."""
        return self.head_dim

    @property
    def importance_heads(self) -> int:
        """Rows of a token's importance: the head groups head pruning
        ranks (each kv head's group under GQA)."""
        return self.num_kv_heads

    @property
    def rope_dim(self) -> int:
        """The rotated lanes of a query / cached key head (the last ones)."""
        return self.head_dim

    @property
    def softmax_scale(self) -> float:
        return 1.0 / self.head_dim ** 0.5

    @staticmethod
    def llama2_7b() -> "ModelConfig":
        return ModelConfig()

    @staticmethod
    def tiny(vocab_size: int = 256) -> "ModelConfig":
        """A tiny model for tests: 2 layers, GQA 4:2, head_dim 8."""
        return ModelConfig(
            vocab_size=vocab_size,
            hidden_size=32,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=8,
            intermediate_size=64,
            max_position_embeddings=512,
        )

    @staticmethod
    def gpt2_small() -> "ModelConfig":
        return ModelConfig(
            vocab_size=50257,
            hidden_size=768,
            num_layers=12,
            num_heads=12,
            num_kv_heads=12,
            head_dim=64,
            intermediate_size=3072,
            norm_eps=1e-5,
            model_type="gpt2",
            activation="gelu",
            use_qkv_bias=True,
            use_mlp_bias=True,
            layernorm_kind="layernorm",
            use_abs_pos_emb=True,
            tie_word_embeddings=True,
            max_position_embeddings=1024,
        )

    @staticmethod
    def gpt2_medium() -> "ModelConfig":
        return dataclasses.replace(
            ModelConfig.gpt2_small(),
            hidden_size=1024,
            num_layers=24,
            num_heads=16,
            num_kv_heads=16,
            head_dim=64,
            intermediate_size=4096,
        )


@dataclass(frozen=True)
class DeepseekV2Config(ModelConfig):
    """DeepSeek-V2: multi-head latent attention (MLA) and routed experts.

    The inherited fields keep their meaning where the architecture has
    one: ``num_heads`` query heads (``num_kv_heads`` as published, equal
    to it), ``head_dim`` the query head's ``qk_nope_head_dim +
    qk_rope_head_dim`` lanes, ``intermediate_size`` the leading dense
    layers' MLP width.  Attention without query compression
    (``q_lora_rank`` null): ``kv_a`` projects a token to a
    ``kv_lora_rank``-lane latent ``c_kv`` (RMS-normed) and
    ``qk_rope_head_dim`` rope lanes ``k_pe`` shared by every head;
    ``kv_b`` expands ``c_kv`` to each head's ``qk_nope_head_dim`` key
    lanes (``W_UK``) and ``v_head_dim`` value lanes (``W_UV``).  The port
    caches one row ``[c_kv || rope(k_pe)]`` per token and layer, a single
    kv head of ``kv_lora_rank + qk_rope_head_dim`` lanes read by every
    query head (group ``num_heads``): ``W_UK`` is folded into the query,
    ``W_UV`` applied to the output's first ``kv_lora_rank`` lanes.
    Positions use YaRN (``yarn_*``; ``yarn_factor`` 1 is plain RoPE).
    After ``first_k_dense_replace`` dense layers each layer routes a token
    to its top ``num_experts_per_tok`` of ``n_routed_experts`` experts of
    width ``moe_intermediate_size`` (softmax router in f32, greedy) and
    adds ``n_shared_experts`` shared experts, one SwiGLU of their summed
    width."""

    model_type: str = "deepseek_v2"
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    yarn_factor: float = 1.0
    yarn_original_max_positions: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    moe_intermediate_size: int = 1408
    n_shared_experts: int = 2
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False

    @property
    def latent(self) -> bool:
        return True

    @property
    def cache_heads(self) -> int:
        return 1

    @property
    def cache_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def importance_heads(self) -> int:
        # each query head is its own group: head pruning ranks them
        return self.num_heads

    @property
    def rope_dim(self) -> int:
        return self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """``(qk_nope + qk_rope) ** -0.5``, times YaRN's
        ``mscale(factor, mscale_all_dim) ** 2`` where that is set (the
        published ``DeepseekV2Attention.softmax_scale``)."""
        scale = (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5
        if self.yarn_mscale_all_dim:
            m = yarn_mscale(self.yarn_factor, self.yarn_mscale_all_dim)
            scale *= m * m
        return scale

    @property
    def moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor ``0.1 * mscale * ln(scale) + 1`` (1 for a
    scale at or below 1)."""
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


@dataclass(frozen=True)
class QuantConfig:
    """KV progressive quantization.

    Two-plane storage mirrors the reference's bit-sliced Buffer
    (Buffer.scala:78-83) + masked LSB writes (SpAttenController.scala:230-232):

    * plane "msb": 4-bit nibbles, packed two-per-uint8 (0.5 B/elem HBM read)
    * plane "full": int8 (1 B/elem), MSB nibble of the int8 == the msb plane

    Pass 1 of attention reads only the msb plane; if the max softmax
    probability for a (batch, kv_head) falls below `requant_threshold`
    (low confidence, mirrors RequantDecision.scala:69-76) the full plane is
    re-fetched and the scores recomputed.
    """

    enabled: bool = True
    requant_threshold: float = 0.08
    enable_requant: bool = True
    # Per-(token, head) K/V scale storage dtype.  The scale planes are
    # read every decode step ([Hkv, C] per layer per sequence);
    # "bfloat16" halves that traffic at ~0.4% relative dequant error on
    # top of int8's own step size (the reference's entire number system
    # is 12-bit fixed, MatrixFetcher.scala:333-361).
    scale_dtype: str = "float32"
    # Per-layer pass-1 bit widths (the reference's per-request
    # QuantProfile, SpAtten.scala:71-74 + MatrixFetcher.scala:48-51 —
    # profiles (4,1), (6,2-fused), (8,1)): each entry is 4, 6, or 8;
    # shorter tuples pad with their last value; None = all layers 4-bit.
    # 6-bit layers read the msb + lsb2 planes (0.75 B/elem); 8-bit layers
    # read the full plane directly and never requantize.  The resolved
    # array lives in DecodeState.quant_bits — policy is data, so a
    # serving layer may override it per request.
    layer_bits: Optional[Tuple[int, ...]] = None
    # Quantize queries to int8 per head row inside the decode kernel and
    # run QK^T as integer MXU dots (the reference hardware computes on
    # 12-bit fixed-point queries, SpAtten.scala:94-120 — fp queries are
    # the approximation, not this).  Requires rope_mode="cached" (rotation
    # must already be folded into the stored keys).
    quantize_queries: bool = False
    # P·V on the integer MXU: the stored int8 V rows are consumed by the
    # matmul directly (no per-block dequant pass on the VPU) and the
    # probability*vscale row weights quantize to 8 bits (the reference's
    # P·V runs on 12-bit fixed-point probabilities,
    # MultiplyValue.scala:19-66).  Applies to the decode kernel in BOTH
    # quantized and dense (int8-KV) modes — it is a compute-precision
    # knob, not a storage one.
    pv_int8: bool = False
    # Store the kernel's unnormalized-probability (e) scratch plane in
    # bfloat16 instead of f32.  The e plane only feeds 8-bit P·V weights
    # (pv_int8), block-mass ranking, and the importance accumulator
    # (itself bf16 in serving configs), so the 8-bit mantissa costs ~the
    # same error as pv_int8's own weight quantization — and it halves
    # the largest [rows, C] VMEM scratch, which is what lets the kernel
    # group more batch rows per grid instance at serving capacities.
    probs_bf16: bool = False

    @property
    def disabled(self) -> "QuantConfig":
        return dataclasses.replace(self, enabled=False, enable_requant=False)

    def resolved_layer_bits(self, num_layers: int) -> Tuple[int, ...]:
        """Per-layer pass-1 bits, padded to num_layers."""
        if not self.enabled:
            return (8,) * num_layers
        if not self.layer_bits:
            return (4,) * num_layers
        bits = tuple(self.layer_bits)[:num_layers]
        return bits + (bits[-1],) * (num_layers - len(bits))

    @property
    def needs_lsb2(self) -> bool:
        return self.enabled and bool(self.layer_bits) and \
            any(b == 6 for b in self.layer_bits)


@dataclass(frozen=True)
class PruningConfig:
    """Token / V / head pruning policy knobs.

    start/important/recent mirror SpAttenKVCache
    (reference spatten_llm/kv_cache_token_pruning.py:24-41); the local-V and
    head knobs come from the hardware plane (TopK stage, workload CSVs).
    """

    # --- cascade token pruning (rolling KV cache) ---
    start_size: int = 4
    important_size: int = 384
    recent_size: int = 384
    enable_token_pruning: bool = True
    # Per-layer cascade schedule: layer l keeps round(important_size *
    # cascade_layer_decay**l) important tokens, so key_fetch_num decays
    # across layers within one iteration — the reference traces' defining
    # signature (summary-gpt2-small-wikitext2-per8.csv: 993->921->716...).
    # 1.0 = uniform budgets (no per-layer decay).
    cascade_layer_decay: float = 1.0
    # Explicit per-layer multipliers on important_size (overrides the
    # geometric decay when set; padded with its last value if shorter than
    # num_layers).  The reference GPT-2-small trace's normalized profile
    # is stepped: (1.0, 0.78, 0.25 x4, 0.14 x6).
    cascade_layer_ratios: Optional[Tuple[float, ...]] = None
    # Importance accumulator EMA: imp <- ema * imp + delta.  1.0 = plain
    # cascade sum; < 1.0 implements the traces' per-row
    # `if_rescale_previous_importance` (CSV col 15) semantics.
    importance_ema: float = 1.0

    # --- local V pruning (per-query top-k over softmax output) ---
    enable_v_pruning: bool = True
    v_keep_ratio: float = 0.35      # value_fetch_num ≈ ratio * key_fetch_num
    v_block_size: int = 16          # granularity of V fetches (≈ buffer line)

    # --- head pruning ---
    enable_head_pruning: bool = False
    head_keep: int = 0              # 0 = keep all heads
    # Re-derive the head mask from live importance every N decode steps
    # inside the jitted scan (0 = once after prefill only).  This is the
    # "on the fly" head pruning of the reference traces (hp-step5 CSVs:
    # later layers keep 10-13/16 heads, mask evolving with the workload).
    head_update_interval: int = 0

    # --- importance signal ---
    # "prob": accumulate softmax probabilities (HPCA'21 paper).
    # "presoftmax": sum of raw scaled QK^T scores over queries — exact parity
    #   with the reference's attn_scores recording
    #   (spatten_llm/pos_shift/modify_llama.py:115-119 + sum(0).sum(1)).
    importance_kind: str = "prob"
    cascade_accumulate: bool = True  # accumulate importance across steps
    # Accumulator storage dtype.  "bfloat16" halves the accumulator's HBM
    # traffic (it is read+written every decode step); its 8-bit mantissa
    # is comparable to the reference's 12-bit fixed-point importance
    # (SpAttenController score_buf) and importance is a ranking signal.
    importance_dtype: str = "float32"

    @property
    def cache_size(self) -> int:
        return self.start_size + self.important_size + self.recent_size


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.  axes: data (DP over batch), model (TP over heads)."""

    data: int = 1
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def num_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class EngineConfig:
    """Serving-engine knobs: batching, cache capacity, dtypes."""

    max_batch_size: int = 8
    cache_capacity: int = 1024      # KV slots per sequence (static shape)
    prefill_chunk: int = 128        # prefill processed in chunks of this many
    # decode runs in jitted windows of this many steps; the cascade-prune
    # trigger and periodic head-mask update run once per window boundary
    # (a per-token lax.cond would round-trip the cache through the cond's
    # buffers every step).  Clamped to the pruning headroom.
    decode_window: int = 64
    max_decode_steps: int = 512
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    use_pallas: bool = True          # fused kernels vs jnp reference path
    # Prefill scores at full precision (skip the 4-bit pass-1 + requant
    # double-pass) while still building the quantized cache and exact
    # importance.  Pass-1 nibble scoring is a DECODE bandwidth
    # optimization — prefill reads each K row once either way and is
    # MXU-bound, so the approximation there costs ~3x prefill throughput
    # for zero fetch savings (the reference's encoder-regime pricing,
    # bert.cpp:17-242, is dense compute too).
    prefill_fp_score: bool = True
    # Local-V masking during prompt chunks.  Default OFF: the reference
    # prices the prompt/encoder regime as DENSE compute (bert.cpp:17-242)
    # — local V pruning is a per-decode-step fetch optimization, and in
    # prefill the V rows stream once regardless, so the per-(query,
    # block) mass/top-k masking costs 8-15% prompt throughput (measured,
    # r5) for zero fetch savings.  Importance accumulates from PRE-mask
    # probabilities in both paths (attention_ref.py:214), so the cascade
    # signal, cache planes, and V budgets are bit-identical either way;
    # only discarded intra-prompt logits differ.  Set True to make the
    # last prompt token's logits match a stepped (decode-mode) replay
    # exactly.
    prefill_v_mask: bool = False
    # RoPE placement for cached keys:
    #   "read"   — store K unrotated, rotate at attention time (exact
    #              reference pos-shift semantics, modify_llama.py:90-104);
    #   "cached" — store K rotated at its slot; a prune re-rotates each
    #              survivor by its slot delta (R(p')x = R(p'-p)R(p)x).
    #              Removes all rope work + tables from the decode kernel at
    #              the cost of one extra int8 requantization per prune
    #              event (rare; amortized over the capacity headroom).
    #              Default: the fused decode kernel runs only in this mode
    #              (or for abs-pos models); "read" keeps the jnp path.
    rope_mode: str = "cached"
    # Permanent head pruning (head_update_interval == 0 keeps the
    # post-prefill mask fixed): physically compact the attention
    # projections to the kept heads for the decode loop — pruned heads
    # stop costing weight bandwidth/FLOPs, not just KV fetches
    # (transformer.compact_head_params; exact vs the masked forward).
    compact_pruned_heads: bool = False
    # Per-layer capacity rungs: cap each layer's physical cache window at
    # the smallest multiple of 2048 above its static keep bound plus
    # headroom (token_pruning.layer_capacities).  Deep cascade layers then
    # prune at ~their budget instead of refilling to full capacity, and
    # the decode kernel compiles per-rung variants with fewer, fatter
    # grid instances (the step is instance-serialization-bound at short
    # live windows).  Only active with token pruning on and capacity a
    # multiple of 2048 (>= 4096).
    layer_cap_rungs: bool = True
    # minimum slack between a layer's keep bound and its rung (also
    # lower-bounds the prune period in decode steps); the effective
    # headroom additionally covers prefill_chunk and decode_window
    layer_cap_headroom: int = 768
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)


@dataclass(frozen=True)
class SpAttenConfig:
    """Top-level bundle handed to the engine."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    pruning: PruningConfig = dataclasses.field(default_factory=PruningConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)

    def validate(self) -> "SpAttenConfig":
        m, p, e = self.model, self.pruning, self.engine
        if m.num_heads % m.num_kv_heads != 0:
            raise ValueError("num_heads must be a multiple of num_kv_heads")
        if p.enable_token_pruning and p.cache_size > e.cache_capacity:
            raise ValueError(
                f"pruning cache_size {p.cache_size} exceeds engine "
                f"cache_capacity {e.cache_capacity}"
            )
        if (p.enable_token_pruning
                and e.prefill_chunk > e.cache_capacity - p.cache_size):
            raise ValueError(
                f"prefill_chunk {e.prefill_chunk} exceeds pruning headroom "
                f"{e.cache_capacity - p.cache_size} (capacity - cache_size); "
                "an appended chunk must fit after a prune"
            )
        if p.enable_head_pruning and p.head_keep > m.num_heads:
            raise ValueError("head_keep exceeds num_heads")
        if e.cache_capacity % p.v_block_size != 0:
            raise ValueError("cache_capacity must be a multiple of v_block_size")
        if self.quant.layer_bits is not None and \
                any(b not in (4, 6, 8) for b in self.quant.layer_bits):
            raise ValueError(
                f"layer_bits entries must be 4, 6, or 8 "
                f"(got {self.quant.layer_bits})")
        if self.quant.needs_lsb2 and e.cache_capacity % 4 != 0:
            raise ValueError(
                "a 6-bit quant profile packs 4 tokens per lsb2 byte; "
                "cache_capacity must be a multiple of 4")
        return self
