"""Fused SpAtten decode attention for one layer of the stacked cache
(kernel K1).

Replaces the TPU kernel ``spatten_tpu/ops/fused_decode.py::
fused_decode_attention`` (``pl.pallas_call`` at :2319): one single-query
decode step, in place --

  append the new K/V row (int8 + per-(token, head) scale + nibble RMW)
  -> pass-1 scores on the 4-bit plane -> masked f32 softmax -> requant
  decision per (b, kv head) and full-plane recompute where it fires ->
  importance EMA into the stacked accumulator -> local V top-k by block
  mass (ties kept) -> P·V over the kept V blocks.

Beside the CUDA kernel (``csrc/fused_decode.cu``, whose header says what
bounds it on the card and how its design handles that) lives its plain
PyTorch version, ``fused_decode_attention_plain``: ``update_token`` then
``spatten_attention_reference`` over the post-append cache.  The wrapper
runs the plain version only for CPU tensors; for CUDA tensors it launches
the kernel or raises.  ``fused_decode_attention.launches`` counts kernel
launches.

The kernel covers the flags of the ported slice: dense int8
(``quant_enabled=False``), the 4-bit msb pass 1 with its nibble RMW
append, requant, EMA importance into the stacked [L, B, Hkv, C]
accumulator, per-layer ``v_keep`` V-block top-k, and GQA.  On CUDA every
other flag (``head_mask``, ``quant_bits``, ``importance_kind`` other than
"prob", delta-mode importance) raises ``NotImplementedError``; the plain
version takes them all.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatten_tpu_torch import kernels
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops.attention_ref import (
    AttentionStats, spatten_attention_reference,
)

_SMEM_LIMIT = 227 * 1024
_THREADS = 256


def _layer_views(k_quant, v_quant, importance_in, layer):
    """Layer ``layer`` of stacked planes (views), or the planes as given."""
    if layer is None:
        return k_quant, v_quant, importance_in
    imp = importance_in[layer] if importance_in is not None else None
    return k_quant.layer(layer), v_quant.layer(layer), imp


def _v_keep_blocks(v_keep, v_block_size: int, cap: int, layer) -> int:
    """The layer's V keep-block count, or 0 when V pruning is off.

    Mirrors the TPU kernel: pruning is on when ANY layer's budget prunes;
    each layer then keeps max(1, ceil(v_keep[l] / v_block)) blocks."""
    vk = (v_keep,) if isinstance(v_keep, int) else tuple(v_keep)
    nvb = cap // v_block_size
    if not any(0 < x and max(1, -(-x // v_block_size)) < nvb for x in vk):
        return 0
    vk_l = vk[min(0 if layer is None else layer, len(vk) - 1)]
    return max(1, -(-vk_l // v_block_size))


def fused_decode_attention_plain(
    q, k_quant, v_quant, k_new, v_new, lengths, *, sm_scale=1.0,
    requant_threshold=0.0, quant_enabled=True, v_keep=0, v_block_size=16,
    head_mask=None, importance_kind="prob", importance_in=None,
    track_importance=True, importance_ema=1.0, layer=None, quant_bits=None,
):
    """Plain PyTorch version of the kernel (same signature, same in-place
    contract).  Returns (out, stats, k_quant, v_quant); ``stats.probs``
    carries the reference probabilities [B, Hq, 1, C]."""
    kq, vq, imp = _layer_views(k_quant, v_quant, importance_in, layer)
    idx = lengths.to(torch.int64) - 1
    qz.update_token(kq, k_new[..., 0, :], idx)
    qz.update_token(vq, v_new[..., 0, :], idx)
    cap = kq.tokens
    kb = _v_keep_blocks(v_keep, v_block_size, cap, layer)
    out, st = spatten_attention_reference(
        q, kq, vq, None, None, lengths, idx[:, None], sm_scale=sm_scale,
        requant_threshold=requant_threshold, quant_enabled=quant_enabled,
        v_keep=kb * v_block_size, v_block_size=v_block_size,
        head_mask=head_mask, importance_kind=importance_kind,
        use_rope=False,
        pass1_bits=(None if quant_bits is None or not quant_enabled
                    else int(quant_bits[0 if layer is None else layer])))
    if not track_importance:
        delta = torch.zeros_like(st.importance_delta)
    elif imp is None:
        delta = st.importance_delta
    else:
        # reset the appended slot, then imp <- ema * imp + delta on the
        # live columns; columns past the length keep their bytes (dead by
        # the layer-length contract).  A fully dead head group is left as
        # it was.
        cols = torch.arange(cap, device=imp.device)
        live = cols[None, None, :] < lengths[:, None, None]
        prev = torch.where(cols[None, None, :] == idx[:, None, None], 0.0,
                           imp.to(torch.float32))
        new = prev * importance_ema + st.importance_delta
        if head_mask is not None:
            hm = head_mask if head_mask.ndim == 2 else head_mask[None]
            alive = hm.expand(q.shape[0], -1).reshape(
                q.shape[0], kq.heads, -1).any(-1)
            live = live & alive[:, :, None]
        imp.copy_(torch.where(live, new, imp.to(torch.float32)).to(imp.dtype))
        delta = importance_in
    return out, st._replace(importance_delta=delta), k_quant, v_quant


def fused_decode_attention(
    q: torch.Tensor,               # [B, Hq, 1, D] (rotated queries)
    k_quant: qz.QuantizedKV,       # planes [(L,) B, C(/2), Hkv*D], in place
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
    head_mask: Optional[torch.Tensor] = None,
    importance_kind: str = "prob",
    importance_in: Optional[torch.Tensor] = None,   # [(L,) B, Hkv, C]
    track_importance: bool = True,
    importance_ema: float = 1.0,
    layer: Optional[int] = None,   # which layer of STACKED planes
    quant_bits: Optional[torch.Tensor] = None,      # int [L] pass-1 bits
    keep_out: Optional[torch.Tensor] = None,        # uint8 [B, Hq, C/vb]
) -> tuple[torch.Tensor, AttentionStats, qz.QuantizedKV, qz.QuantizedKV]:
    """One fused decode step.  Returns (out [B, Hq, 1, D] f32, stats,
    k_quant, v_quant): the cache planes (and the importance accumulator,
    when given) are updated IN PLACE, so the inputs are consumed.

    Stacked mode (``layer`` given): planes carry a leading layer axis and
    only layer ``layer`` is read or written.  ``stats.importance_delta``
    is the accumulator itself when ``importance_in`` is given.
    ``keep_out`` (CUDA only, for checks) receives the per-row kept V-block
    mask when V pruning is on.
    """
    if not q.is_cuda:
        if keep_out is not None:
            raise ValueError("keep_out is a kernel check output (CUDA only)")
        return fused_decode_attention_plain(
            q, k_quant, v_quant, k_new, v_new, lengths, sm_scale=sm_scale,
            requant_threshold=requant_threshold, quant_enabled=quant_enabled,
            v_keep=v_keep, v_block_size=v_block_size, head_mask=head_mask,
            importance_kind=importance_kind, importance_in=importance_in,
            track_importance=track_importance, importance_ema=importance_ema,
            layer=layer, quant_bits=quant_bits)

    if head_mask is not None:
        raise NotImplementedError("K1 on CUDA: head_mask is not ported yet")
    if quant_bits is not None:
        raise NotImplementedError("K1 on CUDA: per-layer quant_bits (6/8-bit "
                                  "profiles) are not ported yet")
    if importance_kind != "prob":
        raise NotImplementedError("K1 on CUDA: importance_kind "
                                  f"{importance_kind!r} is not ported yet")
    if track_importance and importance_in is None:
        raise NotImplementedError("K1 on CUDA: delta-mode importance is not "
                                  "ported yet (pass importance_in)")
    kq, vq, imp = _layer_views(k_quant, v_quant, importance_in, layer)
    b, hq, q_len, d = q.shape
    hkv, cap = kq.heads, kq.tokens
    group = hq // hkv
    if q_len != 1:
        raise ValueError("K1 is a single-query decode step")
    if group not in (1, 2, 4, 8) or d not in (64, 128, 256):
        raise NotImplementedError(f"K1 on CUDA: GQA group {group}, head_dim "
                                  f"{d} (supported: 1/2/4/8 and 64/128/256)")
    if quant_enabled and kq.msb is None:
        raise ValueError("quant_enabled needs the K msb plane")
    if kq.lsb2 is not None or vq.lsb2 is not None:
        raise NotImplementedError("K1 on CUDA: lsb2 planes are not ported yet")
    planes = [kq.full, kq.msb, vq.full, vq.msb]
    expect = [(b, cap, hkv * d), (b, cap // 2, hkv * d)] * 2
    dtypes = [torch.int8, torch.uint8] * 2
    for t, shape, dt in zip(planes, expect, dtypes):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"cache plane {tuple(t.shape)} {t.dtype} is not "
                             f"a contiguous {dt} {shape}")
    for t in (kq.scale, vq.scale) + ((imp,) if track_importance else ()):
        if (tuple(t.shape) != (b, hkv, cap) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise NotImplementedError(
                "K1 on CUDA takes contiguous f32 [B, Hkv, C] scales and "
                "importance")
    if cap % v_block_size or cap % 2:
        raise ValueError("capacity must be even and a multiple of v_block")
    nvb = cap // v_block_size
    smem = 4 * (group * cap + (_THREADS // 32) * (group * d + 1)
                + group * nvb + 3 * group) + (group + 1) * nvb
    if smem > _SMEM_LIMIT:
        raise NotImplementedError(f"K1 on CUDA: capacity {cap} x GQA group "
                                  f"{group} needs {smem} B of shared memory")

    dev = q.device
    qf = q.reshape(b, hq, d).to(torch.float32).contiguous()
    knf = k_new.reshape(b, hkv, d).to(torch.float32).contiguous()
    vnf = v_new.reshape(b, hkv, d).to(torch.float32).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    for t in (kq.full, vq.full, lens):
        if t.device != dev:
            raise ValueError("K1 operands must share one CUDA device")
    out = torch.empty((b, hq, d), dtype=torch.float32, device=dev)
    max_prob = torch.empty((b, hkv), dtype=torch.float32, device=dev)
    need = torch.empty((b, hkv), dtype=torch.uint8, device=dev)
    kb = _v_keep_blocks(v_keep, v_block_size, cap, layer)
    if keep_out is not None and (tuple(keep_out.shape) != (b, hq, nvb)
                                 or keep_out.dtype != torch.uint8):
        raise ValueError(f"keep_out must be uint8 {(b, hq, nvb)}")
    do_requant = quant_enabled and requant_threshold > 0.0
    kernels.launch(
        "fused_decode", qf.data_ptr(), knf.data_ptr(), vnf.data_ptr(),
        lens.data_ptr(), kq.full.data_ptr(),
        kernels.ptr(kq.msb if quant_enabled else None),
        kq.scale.data_ptr(), vq.full.data_ptr(),
        kernels.ptr(vq.msb if quant_enabled else None), vq.scale.data_ptr(),
        kernels.ptr(imp if track_importance else None), out.data_ptr(),
        max_prob.data_ptr(), need.data_ptr(), kernels.ptr(keep_out),
        b, hq, hkv, d, cap, qz.pack_unit(cap),
        float(sm_scale), float(requant_threshold), float(importance_ema),
        int(quant_enabled), int(do_requant), kb, v_block_size)
    fused_decode_attention.launches += 1
    if track_importance:
        delta = importance_in
    else:
        delta = torch.zeros((b, hkv, cap), dtype=torch.float32, device=dev)
    stats = AttentionStats(max_prob=max_prob, need_requant=need.bool(),
                           importance_delta=delta, probs=None)
    return out.reshape(b, hq, 1, d), stats, k_quant, v_quant


fused_decode_attention.launches = 0
