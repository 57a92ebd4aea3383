"""Fused SpAtten decode attention for one layer of the stacked cache
(kernel K1).

Replaces the TPU kernel ``spatten_tpu/ops/fused_decode.py::
fused_decode_attention`` (``pl.pallas_call`` at :2319): one single-query
decode step, in place --

  append the new K/V row (int8 + per-(token, head) scale + nibble and
  2-bit read-modify-writes) -> pass-1 scores on the layer's profile plane
  (4-bit msb, 6-bit msb + lsb2, or int8) -> masked f32 softmax -> requant
  decision per (b, kv head) and int8 recompute where it fires ->
  importance EMA into the stacked accumulator -> local V top-k by block
  mass (ties kept) -> P·V over the kept V blocks (f32, or 8-bit weights
  on the stored int8 rows).

Beside the CUDA kernel (``csrc/fused_decode.cu``, whose header says what
bounds it on the card and how its design handles that) lives its plain
PyTorch version, ``fused_decode_attention_plain``.  The JAX reference
(``attention_ref.py``) has none of the serving flags (int8 queries,
integer P·V, the bf16 probability plane, capacity rungs); they exist only
in the Pallas body, so the plain version follows the body's arithmetic:
pass-1 scores are ``ksc * (raw * rowscale * mult * sm + rowscale * qsum *
(mid - 128) * sm)`` over the biased stored nibbles (exact integers before
scaling when the queries are quantized), and the appended column's P·V
term uses the new row's f32 scales while the stored scale columns hold
their (possibly bf16) rounding.  The wrapper runs the plain version only
for CPU tensors; for CUDA tensors it launches the kernel or raises.
``fused_decode_attention.launches`` counts kernel launches.  The kernel
has instances for GQA groups 1, 2, 4 and 8 and head dims 64, 128 and 256;
a group of 3 runs in the group-4 instance and 5-7 in the group-8 one
(``instance_group``), whose extra rows are padding that the kernel skips,
a group past 8 in the group-8 instance with its score plane in device
memory, as chunks of 8 rows (``plane_rows`` rows, the last chunk padded),
and a head_dim d in the smallest instance dim D >= d (``instance_dim``),
whose lanes past d it reads and never uses; a head past 256 lanes runs in
the D = 256 instances as ``lane_pieces`` boxes of 256 bytes side by side.
``k1_plan`` says where a launch keeps its score plane and its per-V-block
arrays; K1 takes every head_dim (``k1_shape_error``).

One more instance, "latent" (``csrc/fused_decode_latent.cu``), takes a
call with one cached head read by a group of 9-16 query rows of 257-640
lanes -- DeepSeek-V2's latent cache, 16 heads over one row of 576 lanes
-- under the serving path's flags for such a cache (``latent_takes``):
one CTA a batch row streams each tile of the row's lanes once for every
query row and scores and weights it on the int8 tensor cores.  Every
other call keeps the ``<G, D>`` instance it ran before.
``fused_decode_attention.latent_launches`` counts its launches, and the
``k1.launch`` span notes the ``instance`` each launch ran.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from spatten_tpu_torch import kernels
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops.attention_ref import MASK_VALUE, AttentionStats
from spatten_tpu_torch.utils.profiling import tracer

_SMEM_LIMIT = 227 * 1024
_THREADS = 256
_WARPS = _THREADS // 32
_MISC_PER_ROW = 8           # per-row scalars the CUDA kernel keeps in smem
_STAGES = 4                 # the CUDA kernel's tile ring: stages of 16 KB
_STAGE_STRIDE = 16384 + 2304  # of plane rows + their scale segments, and
_BARRIER = 8                # one mbarrier each
_GROUPS = (1, 2, 4, 8)      # the CUDA kernel's <G, D> instance groups
_HEAD_DIMS = (64, 128, 256)  # the CUDA kernel's instance head dims
_META_DTYPES = (torch.float32, torch.bfloat16)
_SUM_COLS = 8               # columns a thread adds at a time (softmax_rows)
# the latent instance (csrc/fused_decode_latent.cu, lat_smem_bytes): its
# query rows (the instance's G), the widest row (five 128-byte boxes), a
# ring of two stages of 64 rows x five boxes + 1 KB of scale segments, the
# 1 KB swizzle alignment, the score rows' padding and its per-row scalars
_LATENT_ROWS = 16
_LATENT_LANES = 640
_LATENT_TILE = 64
_LATENT_STAGES = 2
_LATENT_STAGE_STRIDE = 5 * _LATENT_TILE * 128 + 1024
_LATENT_ALIGN = 1024
_LATENT_PAD = 4
_LATENT_SCALARS = (_MISC_PER_ROW * _LATENT_ROWS + 3 * _LATENT_ROWS * _WARPS
                   + 4 * _LATENT_ROWS + 4)


def _layer_views(k_quant, v_quant, importance_in, layer):
    """Layer ``layer`` of stacked planes (views), or the planes as given."""
    if layer is None:
        return k_quant, v_quant, importance_in
    imp = importance_in[layer] if importance_in is not None else None
    return k_quant.layer(layer), v_quant.layer(layer), imp


def _rung(cap_total: int, cap_override: Optional[int], v_block: int) -> int:
    """The kernel's window: ``cap_override`` when it is a legal prefix of
    the stored capacity (the JAX wrapper's asserts), else the capacity."""
    if cap_override is None or cap_override >= cap_total:
        return cap_total
    unit = qz.pack_unit(cap_total)
    if (cap_override % unit or qz.pack_unit(cap_override) != unit
            or cap_override % v_block):
        raise ValueError(f"cap_override {cap_override} must be a multiple "
                         f"of the pack unit {unit} (with the same unit) and "
                         f"of v_block {v_block}")
    return cap_override


def _prefix(q: qz.QuantizedKV, cap: int) -> qz.QuantizedKV:
    """Views of the first ``cap`` token slots of every plane (a rung is a
    shared prefix of the packed layouts)."""
    if q.tokens == cap:
        return q
    return qz.QuantizedKV(
        full=q.full[..., :cap, :],
        msb=None if q.msb is None else q.msb[..., :cap // 2, :],
        scale=q.scale[..., :cap],
        lsb2=None if q.lsb2 is None else q.lsb2[..., :cap // 4, :])


def _v_keep_blocks(v_keep, v_block_size: int, cap: int, layer) -> int:
    """The layer's V keep-block count, or 0 when V pruning is off.

    Mirrors the TPU kernel: pruning is on when ANY layer's budget prunes
    within the kernel's window ``cap``; each layer then keeps
    max(1, ceil(v_keep[l] / v_block)) blocks."""
    vk = (v_keep,) if isinstance(v_keep, int) else tuple(v_keep)
    nvb = cap // v_block_size
    if not any(0 < x and max(1, -(-x // v_block_size)) < nvb for x in vk):
        return 0
    vk_l = vk[min(0 if layer is None else layer, len(vk) - 1)]
    return max(1, -(-vk_l // v_block_size))


def _layer_bits(quant_enabled, quant_bits, layer, has_lsb2) -> int:
    """Pass-1 bits of this layer: 4, 6 (only with the lsb2 plane; else it
    reads as 4) or 8 (int8 plane; dense mode is 8)."""
    if not quant_enabled:
        return 8
    if quant_bits is None:
        return 4
    bits = int(quant_bits[0 if layer is None else layer])
    return 4 if bits == 6 and not has_lsb2 else bits


def _kth_largest(x: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest per row [..., n] -> [..., 1]: the smallest value whose
    strictly-greater count is below k (the kernel's counting rule)."""
    srt = torch.sort(x, dim=-1, descending=True).values
    i = min(k, x.shape[-1]) - 1
    return srt[..., i:i + 1]


def _ordered_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` summed along ``dim`` one element at a time in index order,
    from 0.0: the order of K1's V-block masses (a block's tokens) and of
    its importance delta (a group's query rows)."""
    acc = torch.zeros_like(x.select(dim, 0))
    for i in range(x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` [..., n], n a power of two, summed as a warp's xor-shuffle
    butterfly sums it: the upper half added to the lower until one value
    is left (every lane ends with lane 0's bits, since a + b == b + a)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _k1_row_sum(e: torch.Tensor) -> torch.Tensor:
    """e [..., C] summed over its last axis as K1's ``softmax_rows`` sums a
    softmax denominator, so that both sides divide by the same bits:
    thread x of the CTA's 256 adds columns 8x + 2048k + j (k, then j,
    ascending) from 0.0, each warp reduces its 32 threads' sums by the
    butterfly, and the 8 warps' sums meet in one more (lanes past 8 add
    0.0).  Columns past a row's length hold 0.0, which adds nothing."""
    span = _THREADS * _SUM_COLS
    x = torch.nn.functional.pad(e, (0, -e.shape[-1] % span))
    x = x.reshape(*e.shape[:-1], -1, _THREADS, _SUM_COLS)
    part = _ordered_sum(x.transpose(-2, -1).flatten(-3, -2), -2)
    return _tree_sum(_tree_sum(part.reshape(*e.shape[:-1], _WARPS, 32)))


def fused_decode_attention_plain(
    q, k_quant, v_quant, k_new, v_new, lengths, *, sm_scale=1.0,
    requant_threshold=0.0, quant_enabled=True, v_keep=0, v_block_size=16,
    head_mask=None, importance_kind="prob", importance_in=None,
    track_importance=True, importance_ema=1.0, layer=None, quant_bits=None,
    quantize_queries=False, pv_int8=False, probs_bf16=False,
    cap_override=None, append_mask=None, return_row_stats=False,
    per_row_importance=False, _skip_append=False,
):
    """Plain PyTorch version of the kernel (same signature, same in-place
    contract).  Returns (out, stats, k_quant, v_quant), and ``(m, den)``
    after them under ``return_row_stats``; ``stats.probs`` carries the
    normalized probabilities the kernel ranks and weights with,
    head-masked, [B, Hq, 1, rung].

    Its float sums run in the CUDA kernel's order (the softmax
    denominator, ``_k1_row_sum``; the V-block masses and the importance
    delta, ``_ordered_sum``) and its score constants in f32 as the kernel
    forms them: with int8 queries and integer P·V the kernel's result
    equals this one bit for bit (a last-bit difference in a denominator
    would move an 8-bit P·V weight near .5 by a whole step, or flip a
    V-block near-tie, and such differences add up over a deep model's
    layers).  Its f32 dot products and f32 P·V sums still run in torch's
    order.  ``_skip_append`` computes the appending step, then puts back
    the int8, nibble and 2-bit planes' bytes (the scales keep the new
    row's, as the Pallas body writes them back)."""
    kq, vq, imp = _layer_views(k_quant, v_quant, importance_in, layer)
    cap = _rung(kq.tokens, cap_override, v_block_size)
    kq, vq = _prefix(kq, cap), _prefix(vq, cap)
    if imp is not None:
        imp = imp[..., :cap]
    b, hq, _, d = q.shape
    hkv = kq.heads
    group = hq // hkv
    dev = q.device
    f32 = torch.float32
    mixed = quant_enabled and quant_bits is not None
    has_lsb2 = mixed and kq.lsb2 is not None
    if has_lsb2 and cap < 32:
        raise ValueError("6-bit profiles need cap >= 32")
    bits = _layer_bits(quant_enabled, quant_bits, layer, has_lsb2)

    if _skip_append:
        kept_planes = [(t, t.clone()) for t in (kq.full, kq.msb, kq.lsb2,
                                               vq.full, vq.msb)
                       if t is not None]
    # ---- append: dense mode keeps no nibble planes up to date, and the
    # 2-bit plane is maintained only under a mixed profile.  A sequence
    # whose append_mask is False writes nothing: its idx column is a
    # stored token like any other (a split-K shard that does not own the
    # tail slot), and it may hold no live token at all
    idx = lengths.to(torch.int64) - 1
    if append_mask is None:
        app = torch.ones(b, dtype=torch.bool, device=dev)
    else:
        app = torch.as_tensor(append_mask, device=dev).to(torch.bool)
    rows_app = None if append_mask is None else torch.nonzero(app)[:, 0]
    qz.update_token(kq._replace(msb=kq.msb if quant_enabled else None,
                                lsb2=kq.lsb2 if has_lsb2 else None),
                    k_new[..., 0, :], idx, rows_app)
    qz.update_token(vq._replace(msb=vq.msb if quant_enabled else None,
                                lsb2=None), v_new[..., 0, :], idx, rows_app)
    _, ksc_new = qz.quantize_rows(k_new[..., 0, :])          # f32 [B, Hkv]
    vq8_new, vsc_new = qz.quantize_rows(v_new[..., 0, :])

    # ---- queries (per-row int8 when quantize_queries) ----------------
    qf = q[..., 0, :].to(f32)                                  # [B, Hq, D]
    if quantize_queries:
        amax = torch.clamp(qf.abs().amax(-1, keepdim=True), min=1e-20)
        rowscale = amax / torch.full_like(amax, 127.0)
        qf = torch.clamp(torch.round(qf / rowscale), -127, 127)
    else:
        rowscale = torch.ones((b, hq, 1), dtype=f32, device=dev)
    qsum = qf.sum(-1, keepdim=True)
    qg = qf.reshape(b, hkv, group, d)

    def raw_scores(keys):                   # keys [B, Hkv, C, D] f32
        return torch.einsum("bhgd,bhcd->bhgc", qg, keys).reshape(b, hq, cap)

    def rows(x):                            # [B, Hkv, ...] -> [B, Hq, ...]
        return x.repeat_interleave(group, dim=1)

    full8 = qz.to_head_major(kq.full, hkv).to(f32)
    if bits == 8:
        raw, mult, mid = raw_scores(full8), 1.0, 0.0
    else:
        nib = qz.to_head_major(qz.unpack_msb(kq.msb), hkv).to(f32) + 8.0
        if bits == 6:
            l2 = qz.to_head_major(qz.unpack_lsb2(kq.lsb2), hkv).to(f32)
            raw, mult, mid = raw_scores(nib * 4.0 + l2), 4.0, qz.MIDPOINT6
        else:
            raw, mult, mid = raw_scores(nib), 16.0, qz.MSB_MIDPOINT
    # the row constants in f32, as the kernel forms them (the midpoint
    # offset rounded once in f32, not once in double and again in f32)
    sm = torch.tensor(sm_scale, dtype=f32, device=dev)
    x = raw * (rowscale * (mult * sm))
    if quant_enabled:
        x = x + (rowscale * qsum) * (
            torch.tensor(mid - 128.0 if bits < 8 else 0.0, dtype=f32,
                         device=dev) * sm)
    ksc = rows(kq.scale.to(f32))                               # [B, Hq, C]
    vsc = rows(vq.scale.to(f32))
    cols = torch.arange(cap, device=dev)
    live = cols[None, None, :] < lengths[:, None, None]        # [B, 1, C]
    at_idx = (cols[None, None, :] == idx[:, None, None]) & app[:, None, None]

    def softmax(s):
        # a row with no live column (an empty shard) keeps m = MASK_VALUE
        # and e = 0, as the Pallas body does
        s = torch.where(live, s * ksc, MASK_VALUE)
        m = s.amax(-1, keepdim=True)
        e = torch.where(live, torch.exp(s - m), 0.0)
        return s, m, e, _k1_row_sum(e)[..., None]

    s, m, e, den = softmax(x)
    col_idx = torch.clamp(idx, min=0).reshape(b, 1, 1).expand(b, hq, 1)

    def at_col(t):                          # [B, Hq, C] -> [B, Hq, 1]
        return t.gather(-1, col_idx)

    x_idx = at_col(x)
    if head_mask is None:
        hm = torch.ones((b, hq), dtype=torch.bool, device=dev)
    else:
        hm = (head_mask if head_mask.ndim == 2 else head_mask[None]
              ).expand(b, hq)
    alive = hm.reshape(b, hkv, group).any(-1)                  # [B, Hkv]
    hmf = hm.to(f32)[..., None]                                # [B, Hq, 1]
    # max prob is taken before head masking (a partly alive group keeps
    # its dead rows' maxima); fully dead groups report 0
    mp = (1.0 / torch.clamp(den, min=1e-30)).reshape(b, hkv, group).amax(-1)
    mp = mp * alive.to(f32)
    need = torch.zeros((b, hkv), dtype=torch.bool, device=dev)
    if quant_enabled and requant_threshold > 0.0 and bits < 8:
        need = alive & (mp < requant_threshold)
    if bool(need.any()):
        x2 = raw_scores(full8) * (rowscale * sm)
        s2, m2, e2, den2 = softmax(x2)
        fire = rows(need)[..., None]
        s, m, e, den = (torch.where(fire, a, c) for a, c in
                        ((s2, s), (m2, m), (e2, e), (den2, den)))
        x_idx = torch.where(fire, at_col(x2), x_idx)
    e_st = e.to(torch.bfloat16).to(f32) if probs_bf16 else e
    wrow = hmf * (1.0 / torch.clamp(den, min=1e-30))
    # the appended column's probability with the new row's f32 scale
    # (non-appending rows weight their idx column from the planes)
    e_idx = torch.where(app[:, None, None],
                        torch.exp(x_idx * rows(ksc_new[..., None]) - m), 0.0)

    kb = _v_keep_blocks(v_keep, v_block_size, cap, layer)
    nvb = cap // v_block_size
    if kb:
        mass = _ordered_sum(e_st.reshape(b, hq, nvb, v_block_size),
                            -1) * hmf
        keep = (mass >= _kth_largest(mass, kb)) & (mass > 0.0)
        keep_cols = keep.repeat_interleave(v_block_size, dim=-1)
        kept_new = at_col(keep_cols).to(f32)
    else:
        keep_cols = torch.ones((b, hq, cap), dtype=torch.bool, device=dev)
        kept_new = torch.ones((b, hq, 1), dtype=f32, device=dev)
    pb = (e_st * wrow) * vsc
    pb = torch.where(live & ~at_idx & keep_cols, pb, 0.0)
    v8 = qz.to_head_major(vq.full, hkv)                        # [B, Hkv, C, D]
    if pv_int8:
        # 8-bit row weights on the stored int8 V; the TPU applies this
        # only where its row tiling allows (fused_decode.py:2050), which
        # holds at Hq rows of 8 or a divisor of 8 -- the port applies the
        # flag as given.  Integer sums are exact in f64.
        emv = (e * vsc).masked_fill(~live, 0.0).amax(-1, keepdim=True)
        wmax = emv * wrow
        # a tensor dividend: PyTorch evaluates ``scalar / tensor`` as a
        # multiply by the reciprocal, not the quotient the kernels take
        wrecip = torch.full_like(wmax, 127.0) / torch.clamp(wmax, min=1e-30)
        w8 = torch.clamp(torch.round(pb * wrecip), 0.0, 127.0)
        acc = torch.einsum("bhgc,bhcd->bhgd",
                           w8.reshape(b, hkv, group, cap).double(),
                           v8.double()).reshape(b, hq, d)
        out = acc.to(f32) * (wmax * (1.0 / 127.0))
    else:
        out = torch.einsum("bhgc,bhcd->bhgd", pb.reshape(b, hkv, group, cap),
                           v8.to(f32)).reshape(b, hq, d)
    vnew = rows(vq8_new.to(f32) * vsc_new[..., None])          # [B, Hq, D]
    out = out + (e_idx * wrow * kept_new) * vnew

    if importance_kind == "prob":
        dsrc = e_st * wrow
    elif importance_kind == "presoftmax":
        # the last scoring pass's masked scaled scores, head-masked
        dsrc = torch.where(live, s, 0.0) * hmf
    else:
        raise ValueError(importance_kind)
    if per_row_importance and imp is None and group > 1:
        delta = dsrc                                           # [B, Hq, C]
    else:
        delta = _ordered_sum(dsrc.reshape(b, hkv, group, cap), 2)
    if not track_importance:
        delta = torch.zeros_like(delta)
    elif imp is not None:
        # reset the appended slot, then imp <- ema * imp + delta on the
        # live columns; columns at or past the length keep their bytes
        # (dead by the layer-length contract), and a fully dead head
        # group is left as it was
        prev = torch.where(at_idx, 0.0, imp.to(f32))
        new = prev * importance_ema + delta
        upd = live & alive[:, :, None]
        imp.copy_(torch.where(upd, new, imp.to(f32)).to(imp.dtype))
        delta = importance_in
    stats = AttentionStats(max_prob=mp, need_requant=need,
                           importance_delta=delta,
                           probs=(e_st * wrow)[:, :, None, :])
    if _skip_append:
        for t, before in kept_planes:
            t.copy_(before)
    if return_row_stats:
        return out[:, :, None, :], stats, k_quant, v_quant, (
            m[..., 0], torch.clamp(den, min=1e-30)[..., 0])
    return out[:, :, None, :], stats, k_quant, v_quant


def instance_group(group: int) -> int:
    """The ``<G, D>`` instance that runs a model's GQA group: the smallest
    of ``_GROUPS`` that holds it (3 runs in 4; 5, 6 and 7 in 8, whose rows
    past the model's group are padding the kernel skips), and 8 for a
    group past 8, which the kernel runs in chunks of 8 rows.  ValueError
    for a group below 1."""
    if group < 1:
        raise ValueError(f"GQA group {group}")
    return next((g for g in _GROUPS if g >= group), _GROUPS[-1])


def plane_rows(group: int) -> int:
    """Score rows of a K1 launch at a model's GQA group: the instance
    group, or for a group past 8 the group rounded up to chunks of 8."""
    inst = instance_group(group)
    return -(-group // inst) * inst


def _lead_in(head_dim: int) -> int:
    """The most bytes before a head's first lane in a 16-byte-aligned box
    row: 16 - gcd(head_dim, 16), or 0 for a multiple of 16."""
    low = head_dim & -head_dim
    return 16 - low if low < 16 else 0


def instance_dim(head_dim: int) -> int:
    """The ``<G, D>`` instance dim that runs a model's head_dim: 64 for 64,
    else the smallest of 128 and 256 that holds its lanes after the box's
    lead-in (K1 reads a head's rows in boxes that start on the 16-byte
    address at or before its first lane: 100 runs in 128, 124 in 256),
    and 256 past 256 lanes, in ``lane_pieces``.  A head_dim below the dim
    is read only in boxes, and a V piece of an odd number of 64-byte rows
    would not land 128-byte aligned, so no head_dim but 64 runs in 64.
    ValueError for a head_dim below 1."""
    if head_dim < 1:
        raise ValueError(f"head_dim {head_dim}")
    if head_dim == _HEAD_DIMS[0]:
        return head_dim
    need = head_dim + _lead_in(head_dim)
    return next((x for x in _HEAD_DIMS[1:] if x >= need), _HEAD_DIMS[-1])


def lane_pieces(head_dim: int) -> int:
    """How many boxes of ``instance_dim`` bytes side by side K1 reads a
    head's rows in, at most (a head whose lanes start on a 16-byte
    address may need one fewer): 1 up to 256 lanes after the lead-in,
    else ceil((head_dim + lead-in) / 256).  A TMA box is at most 256
    bytes wide, so a wider head's passes run once per piece."""
    dim = instance_dim(head_dim)
    return -(-(head_dim + _lead_in(head_dim)) // dim)


def block_bytes(rows: int, nvb: int) -> int:
    """Bytes of one K1 CTA's per-V-block arrays over ``rows`` score rows
    and ``nvb`` V blocks (``block_bytes`` in ``csrc/fused_decode.cu``):
    f32 masses [rows, nvb], the kept-block list and its count (int32
    [nvb + 1]), the keep masks [rows, nvb] and their union [nvb] (bytes).
    A device block plane gives each CTA this rounded up to 16 bytes."""
    return 4 * (rows * nvb + nvb + 1) + (rows + 1) * nvb


def smem_bytes(group: int, head_dim: int, cap: int, v_block: int,
               in_smem: bool = True, rows: Optional[int] = None,
               blocks_in_smem: bool = True) -> int:
    """Shared memory of one K1 CTA of instance ``<group, head_dim>``
    (``group`` one of ``_GROUPS``, ``head_dim`` one of ``_HEAD_DIMS``; see
    ``instance_group`` and ``instance_dim``) over ``rows`` score rows
    (default ``group``; more only with the plane in device memory),
    mirroring ``smem_bytes`` in ``csrc/fused_decode.cu``: the tile ring,
    the [G, cap] score plane (unless it lies in device memory), the
    per-warp P·V partials, scalars per row and, unless they lie in device
    memory, the per-V-block arrays (``block_bytes``)."""
    if group not in _GROUPS:
        raise ValueError(f"group {group} is not a K1 instance group "
                         f"{_GROUPS}")
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not a K1 instance dim "
                         f"{_HEAD_DIMS}")
    rows = group if rows is None else rows
    if in_smem and rows != group:
        raise ValueError("a score plane in shared memory holds the "
                         "instance group's rows")
    if in_smem and not blocks_in_smem:
        raise ValueError("the V-block arrays leave shared memory only "
                         "with the score plane")
    nvb = cap // v_block
    return (_STAGES * (_STAGE_STRIDE + _BARRIER)
            + 4 * (group * cap * in_smem + _WARPS * group * head_dim
                   + _WARPS + _MISC_PER_ROW * rows + 2)
            + block_bytes(rows, nvb) * blocks_in_smem)


def scores_in_smem(group: int, head_dim: int, cap: int, v_block: int
                   ) -> bool:
    """Whether K1 instance ``<group, head_dim>`` keeps its [G, cap] score plane
    in shared memory: where the whole plan fits the card's 227 KB per
    block.  Past that the wrapper gives the kernel a plane in device
    memory."""
    return smem_bytes(group, head_dim, cap, v_block) <= _SMEM_LIMIT


class K1Plan(NamedTuple):
    """Where a K1 launch keeps its planes (``k1_plan``)."""
    inst: int                 # the <G, D> instance's group
    dim: int                  # and head dim
    rows: int                 # score rows (``plane_rows``)
    scores_in_smem: bool      # the [rows, rung] score plane
    blocks_in_smem: bool      # the per-V-block arrays
    smem: int                 # shared memory of one CTA
    latent: bool = False      # the latent instance (inst 16, dim 640)


def latent_smem_bytes(rung: int, v_block: int, in_smem: bool = True) -> int:
    """Shared memory of one CTA of the latent instance over a window of
    ``rung`` tokens, mirroring ``lat_smem_bytes`` in
    ``csrc/fused_decode_latent.cu``: the alignment slack, the ring of two
    41 KB stages and their barriers, the per-row scalars, the [16, rung +
    4] f32 score plane (unless it lies in device memory) and the per-V-
    block arrays.  At v_block 64 the plane fits 227 KB up to a rung of
    2,176 tokens (2048: 221,380 B); past that it moves to device memory
    (4096: 92,772 B), and the rest fits up to 1,707 V blocks (109,248
    tokens at v_block 64); past that the call keeps ``<8, 256, false>``."""
    nvb = rung // v_block
    return (_LATENT_ALIGN + _LATENT_STAGES * (_LATENT_STAGE_STRIDE + _BARRIER)
            + 4 * _LATENT_SCALARS
            + 4 * _LATENT_ROWS * (rung + _LATENT_PAD) * in_smem
            + 4 * _LATENT_ROWS * nvb + 4 * (nvb + 1)
            + (_LATENT_ROWS + 1) * nvb)


def latent_takes(kv_heads: int, cap_total: int, *, quant_enabled: bool,
                 has_lsb2: bool, quantize_queries: bool, pv_int8: bool,
                 importance_kind: str, delta_rows: bool,
                 append_mask=None, return_row_stats: bool = False,
                 skip_append: bool = False) -> bool:
    """Whether a K1 call's cached heads, capacity and flags are the latent
    instance's (``k1_plan(..., latent=True)`` then checks the group, the
    row width, v_block and the plan): one cached head; quantized planes,
    int8 queries and 8-bit P·V; "prob" importance handed back as this
    step's delta per query row (``delta_rows``: tracked, per_row_importance,
    no accumulator); no append mask, row stats or ``_skip_append``; and a
    pack unit whose halves (and, with the 2-bit plane, quarters) hold whole
    tiles of packed rows (64, or 32 beside their 2-bit rows).  The head
    mask, the rung, the layer bits, the requant threshold, probs_bf16 and
    f32 or bf16 scales may be anything."""
    if not (kv_heads == 1 and quant_enabled and quantize_queries and pv_int8
            and importance_kind == "prob" and delta_rows
            and append_mask is None and not return_row_stats
            and not skip_append):
        return False
    unit = qz.pack_unit(cap_total)
    tile = _LATENT_TILE // 2 if has_lsb2 else _LATENT_TILE
    return (unit // 2) % tile == 0 and (
        not has_lsb2 or (unit // 4) % tile == 0)


def _latent_shape(group: int, head_dim: int, v_block: int) -> bool:
    """The group, row width and V block the latent instance takes: 9-16
    query rows (M = 16 of its products; rows past the group are padding),
    257-640 lanes in whole 16-byte columns, and a V block of 32, or of a
    multiple of 64 (a k-step of 32 tokens lies inside one block, and a
    tile of 64 rows is whole blocks or inside one)."""
    return (8 < group <= _LATENT_ROWS and 256 < head_dim <= _LATENT_LANES
            and head_dim % 16 == 0
            and (v_block == 32 or (v_block > 0 and v_block % 64 == 0)))


def k1_plan(group: int, head_dim: int, rung: int, v_block: int,
            latent: bool = False) -> K1Plan:
    """The plan of a K1 launch at a model's GQA group and head_dim over a
    window of ``rung`` tokens: everything in shared memory where it fits
    227 KB (and the group fits its instance); else the score plane in
    device memory; else the per-V-block arrays there too.  The plan does
    not depend on ``lane_pieces``: the pieces of a head share the ring,
    the score plane and the P·V partials.

    ``latent``: the call's cached heads and flags admit the latent
    instance (``latent_takes``); it runs there when its group, row width
    and V block are the instance's (``_latent_shape``) and its plan fits:
    the [16, rung] score plane in shared memory (to ~2.2k tokens) or else
    in device memory."""
    if latent and _latent_shape(group, head_dim, v_block):
        smem = latent_smem_bytes(rung, v_block)
        if smem <= _SMEM_LIMIT:
            return K1Plan(_LATENT_ROWS, _LATENT_LANES, _LATENT_ROWS, True,
                          True, smem, True)
        smem = latent_smem_bytes(rung, v_block, False)
        if smem <= _SMEM_LIMIT:
            return K1Plan(_LATENT_ROWS, _LATENT_LANES, _LATENT_ROWS, False,
                          True, smem, True)
    inst, dim = instance_group(group), instance_dim(head_dim)
    rows = plane_rows(group)
    if rows == inst and scores_in_smem(inst, dim, rung, v_block):
        return K1Plan(inst, dim, rows, True, True,
                      smem_bytes(inst, dim, rung, v_block))
    smem = smem_bytes(inst, dim, rung, v_block, False, rows)
    if smem <= _SMEM_LIMIT:
        return K1Plan(inst, dim, rows, False, True, smem)
    return K1Plan(inst, dim, rows, False, False,
                  smem_bytes(inst, dim, rung, v_block, False, rows, False))


def check_smem(group: int, head_dim: int, cap: int, v_block: int) -> int:
    """The shared memory of a K1 launch of instance group ``group`` with
    its score plane in shared memory; NotImplementedError past the card's
    227 KB per block."""
    smem = smem_bytes(group, head_dim, cap, v_block)
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(
            f"K1 on CUDA: window {cap} x GQA group {group} needs {smem} B "
            "of shared memory")
    return smem


def k1_shape_error(group: int, head_dim: int, cap_total: int, rung: int,
                   v_block: int) -> Optional[str]:
    """Why K1 on the card does not take a call of this shape, or None when
    it does.  It takes every GQA group (past 8 in chunks of 8 rows), every
    head_dim (past 256 lanes in ``lane_pieces``) and every window (the
    score plane and then the per-V-block arrays move to device memory as
    the window grows, ``k1_plan``), and any stored capacity and rung the
    wrapper's layout rules admit.  The wrapper raises
    ``NotImplementedError`` with this message."""
    if group < 1:
        return f"K1 on CUDA: GQA group {group}"
    if head_dim < 1:
        return f"K1 on CUDA: head_dim {head_dim}"
    plan = k1_plan(group, head_dim, rung, v_block)
    if plan.smem > _SMEM_LIMIT:
        return (f"K1 on CUDA: window {rung} x GQA group {group} needs "
                f"{plan.smem} B of shared memory with its score plane and "
                "V-block arrays in device memory")
    return None


def fused_decode_attention(
    q: torch.Tensor,               # [B, Hq, 1, D] (rotated queries)
    k_quant: qz.QuantizedKV,       # planes [(L,) B, C(/2,/4), Hkv*D], in place
    v_quant: qz.QuantizedKV,
    k_new: torch.Tensor,           # [B, Hkv, 1, D] new K row (rotated)
    v_new: torch.Tensor,           # [B, Hkv, 1, D] new V row
    lengths: torch.Tensor,         # [B] int32 valid tokens INCL. new row
    *,
    sm_scale: float = 1.0,
    requant_threshold: float = 0.0,
    quant_enabled: bool = True,
    v_keep=0,                      # int, or per-layer ints [L]
    v_block_size: int = 16,
    head_mask: Optional[torch.Tensor] = None,       # bool [Hq] or [B, Hq]
    importance_kind: str = "prob",
    importance_in: Optional[torch.Tensor] = None,   # [(L,) B, Hkv, C]
    track_importance: bool = True,
    importance_ema: float = 1.0,
    layer: Optional[int] = None,   # which layer of STACKED planes
    quant_bits: Optional[torch.Tensor] = None,      # int [L] pass-1 bits
    quantize_queries: bool = False,
    pv_int8: bool = False,
    probs_bf16: bool = False,
    cap_override: Optional[int] = None,             # capacity rung
    append_mask: Optional[torch.Tensor] = None,     # bool [B]
    return_row_stats: bool = False,
    per_row_importance: bool = False,
    keep_out: Optional[torch.Tensor] = None,        # uint8 [B, Hq, rung/vb]
    _skip_append: bool = False,    # perf triage: no plane byte written
):
    """One fused decode step.  Returns (out [B, Hq, 1, D] f32, stats,
    k_quant, v_quant): the cache planes (and the importance accumulator,
    when given) are updated IN PLACE, so the inputs are consumed.

    Stacked mode (``layer`` given): planes carry a leading layer axis and
    only layer ``layer`` is read or written.  ``cap_override`` sizes the
    call to a prefix of the stored capacity (lengths stay at or under
    it).  ``stats.importance_delta`` is the accumulator itself when
    ``importance_in`` is given; without it (delta mode) it is this step's
    delta [B, Hkv, rung], zero outside the live columns, or per query row
    [B, Hq, rung] under ``per_row_importance`` with GQA.
    ``importance_kind``: "prob" (softmax probabilities) or "presoftmax"
    (the masked scaled scores of the last scoring pass).

    The split-K flags: ``append_mask`` False leaves a sequence's planes
    untouched and scores its idx column as a stored token (such a
    sequence may hold no live token: zero output, m = MASK_VALUE, den =
    1e-30); ``return_row_stats`` adds ``(m, den)`` [B, Hq], the per-row
    softmax max and denominator, as a fifth result.  ``keep_out`` (CUDA
    only, for checks) receives the per-row kept V-block mask when V
    pruning is on.

    ``_skip_append`` (perf triage, the Pallas kernel's flag of that name):
    the step returns what the appending step returns, the appended column
    scored, weighted and reset as the new row, but writes no byte of the
    int8, nibble or 2-bit planes; the scale planes take the new row's
    scales (the Pallas body writes its scale windows back either way).
    K1's passes read the appended row back from the planes, so on the
    card the C entry brackets the unchanged K1 launch with a small kernel
    that saves the bytes the append overwrites into a stash in device
    memory and one that puts them back: the flag prices nothing of the
    append there.
    """
    flags = dict(
        sm_scale=sm_scale, requant_threshold=requant_threshold,
        quant_enabled=quant_enabled, v_keep=v_keep,
        v_block_size=v_block_size, head_mask=head_mask,
        importance_kind=importance_kind, importance_in=importance_in,
        track_importance=track_importance, importance_ema=importance_ema,
        layer=layer, quant_bits=quant_bits,
        quantize_queries=quantize_queries, pv_int8=pv_int8,
        probs_bf16=probs_bf16, cap_override=cap_override,
        append_mask=append_mask, return_row_stats=return_row_stats,
        per_row_importance=per_row_importance, _skip_append=_skip_append)
    if not q.is_cuda:
        if keep_out is not None:
            raise ValueError("keep_out is a kernel check output (CUDA only)")
        return fused_decode_attention_plain(
            q, k_quant, v_quant, k_new, v_new, lengths, **flags)

    with tracer.span("k1.launch") as span:
        if importance_kind not in ("prob", "presoftmax"):
            raise ValueError(importance_kind)
        kq, vq, imp = _layer_views(k_quant, v_quant, importance_in, layer)
        b, hq, q_len, d = q.shape
        hkv, cap_total = kq.heads, kq.tokens
        if hq % hkv:
            raise ValueError(f"{hq} query heads over {hkv} kv heads")
        group = hq // hkv
        cap = _rung(cap_total, cap_override, v_block_size)
        if q_len != 1:
            raise ValueError("K1 is a single-query decode step")
        if quant_enabled and kq.msb is None:
            raise ValueError("quant_enabled needs the K msb plane")
        mixed = quant_enabled and quant_bits is not None
        has_lsb2 = mixed and kq.lsb2 is not None
        if has_lsb2 and cap < 32:
            raise ValueError("6-bit profiles need cap >= 32")
        planes = [kq.full, kq.msb, kq.lsb2 if has_lsb2 else None, vq.full,
                  vq.msb]
        expect = [(b, cap_total, hkv * d), (b, cap_total // 2, hkv * d),
                  (b, cap_total // 4, hkv * d), (b, cap_total, hkv * d),
                  (b, cap_total // 2, hkv * d)]
        dtypes = [torch.int8, torch.uint8, torch.uint8, torch.int8,
                  torch.uint8]
        for t, shape, dt in zip(planes, expect, dtypes):
            if t is None:
                continue
            if (tuple(t.shape) != shape or t.dtype != dt
                    or not t.is_contiguous()):
                raise ValueError(f"cache plane {tuple(t.shape)} {t.dtype} is "
                                 f"not a contiguous {dt} {shape}")
        accumulate = track_importance and imp is not None
        per_row = per_row_importance and track_importance and not accumulate \
            and group > 1
        meta = [kq.scale, vq.scale] + ([imp] if accumulate else [])
        for t in meta:
            if (tuple(t.shape) != (b, hkv, cap_total) or t.dtype not in
                    _META_DTYPES or not t.is_contiguous()):
                raise ValueError("K1 takes contiguous f32 or bf16 [B, Hkv, C] "
                                 "scales and importance")
        if kq.scale.dtype != vq.scale.dtype:
            raise ValueError("K and V scales must share one dtype")
        if cap % v_block_size or cap % 2:
            raise ValueError("capacity must be even and a multiple of v_block")
        if has_lsb2 and qz.pack_unit(cap_total) % 4:
            raise ValueError("the 2-bit plane needs a pack unit of 4k tokens")
        if (hkv * d) % 16:
            raise ValueError(f"K1 needs a lane width Hkv * D ({hkv * d}) that "
                             "is a multiple of 16 bytes")
        shape_error = k1_shape_error(group, d, cap_total, cap, v_block_size)
        if shape_error:
            raise NotImplementedError(shape_error)
        latent = latent_takes(
            hkv, cap_total, quant_enabled=quant_enabled, has_lsb2=has_lsb2,
            quantize_queries=quantize_queries, pv_int8=pv_int8,
            importance_kind=importance_kind, delta_rows=per_row,
            append_mask=append_mask, return_row_stats=return_row_stats,
            skip_append=_skip_append)
        # the <G, D> instance, or the latent one
        plan = k1_plan(group, d, cap, v_block_size, latent=latent)
        if tracer.on:
            span.note(instance="latent" if plan.latent
                      else f"<{plan.inst}, {plan.dim}>")
        nvb = cap // v_block_size

        dev = q.device
        qf = q.reshape(b, hq, d).to(torch.float32).contiguous()
        knf = k_new.reshape(b, hkv, d).to(torch.float32).contiguous()
        vnf = v_new.reshape(b, hkv, d).to(torch.float32).contiguous()
        lens = lengths.to(torch.int32).contiguous()
        hmask = None
        if head_mask is not None:
            hmask = (head_mask if head_mask.ndim == 2 else head_mask[None]
                     ).expand(b, hq).to(torch.uint8).contiguous()
        qbits = None
        if mixed:
            qbits = torch.as_tensor(quant_bits, dtype=torch.int32,
                                    device=dev).contiguous()
        appm = None
        if append_mask is not None:
            appm = torch.as_tensor(append_mask, device=dev).to(
                torch.uint8).reshape(b).contiguous()
        for t in (kq.full, vq.full, lens) + tuple(
                x for x in (hmask, qbits, appm) if x is not None):
            if t.device != dev:
                raise ValueError("K1 operands must share one CUDA device")
        out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
        max_prob = torch.empty((b, hkv), dtype=torch.float32, device=dev)
        need = torch.empty((b, hkv), dtype=torch.uint8, device=dev)
        # delta mode: the kernel writes every column of the rung (zeros past a
        # row's length), so the output needs no clearing
        delta = None
        if track_importance and not accumulate:
            delta = torch.empty((b, hq if per_row else hkv, cap),
                                dtype=torch.float32, device=dev)
        # the score plane, where the instance's shared-memory plan cannot hold
        # it (or the group runs in chunks): one [rows, cap] slice per CTA,
        # padding rows included (the latent instance's rows at a stride of
        # cap + 4); and the per-V-block arrays, where the plan cannot hold
        # them either: one 16-byte-aligned slice per CTA
        splane = bplane = None
        if not plan.scores_in_smem:
            stride = cap + _LATENT_PAD if plan.latent else cap
            splane = torch.empty((b, hkv, plan.rows, stride),
                                 dtype=torch.float32, device=dev)
        if not plan.blocks_in_smem:
            stride = -(-block_bytes(plan.rows, nvb) // 16) * 16
            bplane = torch.empty((b, hkv, stride), dtype=torch.uint8,
                                 device=dev)
        m_rows = den_rows = None
        if return_row_stats:
            m_rows = torch.empty((b, hq), dtype=torch.float32, device=dev)
            den_rows = torch.empty((b, hq), dtype=torch.float32, device=dev)
        kb = _v_keep_blocks(v_keep, v_block_size, cap, layer)
        if keep_out is not None and (tuple(keep_out.shape) != (b, hq, nvb)
                                     or keep_out.dtype != torch.uint8):
            raise ValueError(f"keep_out must be uint8 {(b, hq, nvb)}")
        do_requant = quant_enabled and requant_threshold > 0.0
        # skip_append: the five rows of d bytes each K1 CTA's append writes
        stash = None
        if _skip_append:
            stash = torch.empty((b, hkv, 5, d), dtype=torch.uint8, device=dev)
        kernels.launch(
            "fused_decode", qf, knf, vnf, lens, kq.full,
            kq.msb if quant_enabled else None, kq.lsb2 if has_lsb2 else None,
            kq.scale, vq.full, vq.msb if quant_enabled else None, vq.scale,
            imp if accumulate else None, hmask, qbits, appm, out, max_prob,
            need, keep_out, delta, m_rows, den_rows, splane,
            b, hq, hkv, plan.inst, plan.dim, d, cap,
            cap_total,
            qz.pack_unit(cap_total),
            0 if layer is None else int(layer),
            float(sm_scale), float(requant_threshold), float(importance_ema),
            int(quant_enabled), int(do_requant), kb, v_block_size,
            int(kq.scale.dtype == torch.bfloat16),
            int(accumulate and imp.dtype == torch.bfloat16),
            int(quantize_queries), int(pv_int8), int(probs_bf16),
            int(importance_kind == "presoftmax"), int(per_row), stash, d,
            bplane)
    fused_decode_attention.launches += 1
    if plan.latent:
        fused_decode_attention.latent_launches += 1
    if accumulate:
        delta = importance_in
    elif delta is None:
        delta = torch.zeros((b, hkv, cap), dtype=torch.float32, device=dev)
    stats = AttentionStats(max_prob=max_prob, need_requant=need.bool(),
                           importance_delta=delta, probs=None)
    if return_row_stats:
        return (out.reshape(b, hq, 1, d), stats, k_quant, v_quant,
                (m_rows, den_rows))
    return out.reshape(b, hq, 1, d), stats, k_quant, v_quant


fused_decode_attention.launches = 0
fused_decode_attention.latent_launches = 0
