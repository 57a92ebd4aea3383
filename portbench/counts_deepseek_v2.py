"""Frozen operation and byte counts of DeepSeek-V2 (the ``deepseek_v2``
model path's arithmetic; ``counts.py`` says what a count is: what the
inputs need, whatever implements them).

Model FLOPs count the active parameters only, in the published form:
the attention projections (q, kv_a, the kv_b up-projection of the latent,
o), the router, a token's routed experts and the shared experts; the
attention itself as 16 heads with QK over nope + rope lanes and P.V over
v lanes.  The cache's bytes are those of the latent row: the key side
reads all its lanes, the value side only the latent lanes; a layout that
pads a row or stores it twice reads as a lower share of the roofline,
never a higher one.
"""

from __future__ import annotations

from portbench.counts import chunk_context, pack_unit  # noqa: F401


def _attn_params(c: dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    rank, nope, rope, vd = (c["kv_lora_rank"], c["qk_nope_head_dim"],
                            c["qk_rope_head_dim"], c["v_head_dim"])
    return (d * h * (nope + rope) + d * (rank + rope)
            + rank * h * (nope + vd) + h * vd * d)


def active_params(c: dict) -> int:
    """Weights a token multiplies through in the decoder layers."""
    d = c["hidden_size"]
    layers, k = c["num_hidden_layers"], c["first_k_dense_replace"]
    im = c["moe_intermediate_size"]
    dense_mlp = 3 * d * c["intermediate_size"]
    moe_mlp = (d * c["n_routed_experts"]
               + (c["num_experts_per_tok"] + c["n_shared_experts"])
               * 3 * d * im)
    return (layers * _attn_params(c) + k * dense_mlp
            + (layers - k) * moe_mlp)


def attention_flops(c: dict, context: float) -> float:
    """QK (nope + rope lanes) and P.V (v lanes) FLOPs of every query head
    over ``context`` (query, key) pairs summed over the layers."""
    h = c["num_attention_heads"]
    return 2.0 * h * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                      + c["v_head_dim"]) * context


def token_flops(c: dict, context: float, logits: bool) -> float:
    """Model FLOPs of one token: 2 per active weight, the output head where
    its logits are used, attention over ``context``."""
    flops = 2.0 * active_params(c) + attention_flops(c, context)
    if logits:
        flops += 2.0 * c["hidden_size"] * c["vocab_size"]
    return flops


# the rope lanes of the latent row: ``qk_rope_head_dim`` of every
# published DeepSeek-V2 configuration
ROPE_LANES = 64


def k1_bytes(lengths, alive, fired, kept, *, kv_heads: int, group: int,
             head_dim: int, capacity: int, rung: int, scale_bytes: int,
             imp_bytes: int, rope: int = ROPE_LANES,
             live_heads=None) -> int:
    """Bytes one fused decode attention call over the latent cache (one
    layer, every row) needs, with ``counts.k1_bytes``'s arguments: the
    cache holds ``kv_heads`` (one) rows of ``head_dim`` lanes a token,
    ``head_dim - rope`` of them latent, each read by ``group`` query
    heads.  As ``counts.k1_bytes`` counts them for a 4-bit pass 1: per row
    of live length n and cached head, the appended latent row written
    once (int8, its nibbles, its scale); where the head is alive the
    packed 4-bit rows of the live tokens at all ``head_dim`` lanes, the
    int8 rows again where it requantizes, their scales, the live query
    heads' importance rows read and written, and the kept V rows at the
    latent lanes with their scales; per row the f32 queries (``head_dim``
    lanes), the outputs (latent lanes), the new row and the stats.

    lengths [B]; alive, fired [B][kv_heads] (bool); kept [B][kv_heads]
    kept V tokens; live_heads [B][kv_heads] the query heads alive under
    each cached head (None: all ``group`` where it is alive)."""
    w, latent = head_dim, head_dim - rope
    u = pack_unit(capacity)
    units = range(rung // u)
    total = 0
    for b, n in enumerate(lengths):
        n = int(n)
        msb_rows = sum(min(max(n - k * u, 0), u // 2) for k in units)
        for h in range(kv_heads):
            total += w + w // 2 + scale_bytes
            if not alive[b][h]:
                continue
            heads = group if live_heads is None else int(live_heads[b][h])
            total += msb_rows * w + (n * w if fired[b][h] else 0)
            total += n * scale_bytes + 2 * heads * n * imp_bytes
            total += int(kept[b][h]) * (latent + scale_bytes)
    rows = len(lengths)
    total += 4 * rows * kv_heads * (group * w + group * latent + w)
    total += rows * kv_heads * 5
    return total


def k2_bytes(moved_rows: int, kept_rows: int, kv_heads: int,
             head_dim: int) -> int:
    """Bytes one prune compaction call needs (``counts.k2_bytes``): each
    moved latent row of K and of V read and written, and the keep list of
    every kept token read."""
    return moved_rows * head_dim * 2 * 2 + kept_rows * kv_heads * 4


def moe_bytes(hits, hidden: int, inter: int, dtype_bytes: int = 2) -> int:
    """Bytes one expert layer's grouped GEMMs need for ``hits`` rows per
    expert: the gate, up and down weights of every expert that received
    a row, each read once, and the rows in and out of both GEMMs (the
    hidden rows in, the gate and up rows out; the activated rows in, the
    hidden rows out)."""
    weights = sum(1 for r in hits if r) * 3 * hidden * inter
    rows = sum(hits) * (hidden + 2 * inter + inter + hidden)
    return dtype_bytes * (weights + rows)
