"""Frozen operation and byte counts, and the card's published peaks.

Each count is what the inputs need, whatever implements them: the bytes a
kernel has to read and write for these lengths and decisions, each input
byte read once and each output byte written once, and the model FLOPs of
the tokens processed.  A later change that fuses or removes a kernel
therefore cannot make a share of a peak read high.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense (no sparsity), at its 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def pack_unit(tokens: int, target: int = 1024) -> int:
    """Token span of one nibble-split unit of a cache of ``tokens`` slots
    (the packed layout's unit, ``ops/quantize.pack_unit``)."""
    half = tokens // 2
    nb = max(1, -(-half // target))
    while half % nb:
        nb += 1
    return 2 * (half // nb)


def k1_bytes(lengths, alive, fired, kept, *, kv_heads: int, group: int,
             head_dim: int, capacity: int, rung: int, scale_bytes: int,
             imp_bytes: int) -> int:
    """Bytes one fused decode attention call (one layer, every row) needs,
    copied from ``chip_smoke.k1_bound`` for a 4-bit pass 1 with the
    importance accumulated: per row of live length n and kv head, the
    appended row written (int8 K and V, their nibble bytes, two scales);
    for a live head group the packed 4-bit rows of its live tokens, the
    int8 rows again where it requantizes, its K scales, its importance
    read and written and its kept V rows with their scales; per row the
    f32 query, output, new K / V and the stats.

    lengths [B]; alive, fired [B][H] (bool); kept [B][H] kept V tokens."""
    d = head_dim
    u = pack_unit(capacity)
    units = range(rung // u)
    total = 0
    for b, n in enumerate(lengths):
        n = int(n)
        msb_rows = sum(min(max(n - k * u, 0), u // 2) for k in units)
        for h in range(kv_heads):
            total += 2 * d + 2 * scale_bytes + 2 * d
            if not alive[b][h]:
                continue
            total += msb_rows * d + (n * d if fired[b][h] else 0)
            total += n * scale_bytes + 2 * n * imp_bytes
            total += int(kept[b][h]) * (d + scale_bytes)
    rows = len(lengths)
    total += 4 * rows * (kv_heads * group * d * 2 + 2 * kv_heads * d)
    total += rows * kv_heads * 5
    return total


def k2_bytes(moved_rows: int, kept_rows: int, kv_heads: int,
             head_dim: int) -> int:
    """Bytes one prune compaction call needs (``chip_smoke.phase_k2``'s
    bound): each moved (token, head) row of K and of V read and written,
    and the keep list of every kept token read."""
    return moved_rows * head_dim * 2 * 2 + kept_rows * kv_heads * 4


def matmul_params(c: dict) -> int:
    """Weights a token multiplies through in the decoder layers (q, k, v,
    o, gate, up, down) of a Llama-layout config."""
    d = c["hidden_size"]
    hq = c["num_attention_heads"]
    hkv = c["num_key_value_heads"]
    dh = c.get("head_dim") or d // hq
    inter = c["intermediate_size"]
    per_layer = d * hq * dh * 2 + d * hkv * dh * 2 + 3 * d * inter
    return c["num_hidden_layers"] * per_layer


def attention_flops(c: dict, context: float) -> float:
    """QK and PV FLOPs of every query head over ``context`` (query, key)
    pairs summed over the layers."""
    hq = c["num_attention_heads"]
    dh = c.get("head_dim") or c["hidden_size"] // hq
    return 4.0 * hq * dh * context


def token_flops(c: dict, context: float, logits: bool) -> float:
    """Model FLOPs of one token: 2 per weight it multiplies through, the
    output head where its logits are used, and attention over ``context``
    tokens summed over the layers."""
    flops = 2.0 * matmul_params(c) + attention_flops(c, context)
    if logits:
        flops += 2.0 * c["hidden_size"] * c["vocab_size"]
    return flops


def chunk_context(start: int, size: int) -> float:
    """Sum over a prompt chunk's queries of the tokens each attends to
    (causal, the chunk starting at ``start`` live tokens)."""
    return size * start + size * (size + 1) / 2


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-quantile (0 < q <= 1) of ``values``: the
    smallest value with at least a share ``q`` of them at or below it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(0, math.ceil(q * len(vals)) - 1)]
