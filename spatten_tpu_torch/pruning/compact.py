"""Prune compaction: gather + moved-row-only delta re-rotation +
requantization + prefix nibble repack (port of
``spatten_tpu/pruning/compact.py``).

* Rows with delta == 0 (start tokens, the order-preserved part of the
  recent window and, via identity ``keep_idx``, every untriggered
  sequence) are copied bit for bit; only moved rows (delta < 0) are
  dequantized, re-rotated by their slot delta and requantized.
* The packed nibble planes use a unit-local layout, so repacking the kept
  prefix touches only the units it covers.

On CUDA tensors whose head_dim K2 takes (``compact_gather.k2_takes``)
the int8 K/V payload moves through kernel K2
(``ops/compact_gather.gather_compact_rows``) in place, and this module
only re-rotates, repacks and compacts the metadata over the compacted
prefix; on CPU tensors, and for other head_dims, it gathers with
``torch.gather`` (the JAX ``use_gather_kernel=False`` path).  Slots past
the live keep count hold garbage that the engine's ``layer_lengths``
contract keeps dead; its bytes differ between the two paths.

Everything is updated IN PLACE: the input cache and importance are
consumed and returned.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatten_tpu_torch.engine.kv_cache import LayerKVCache
from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.ops.compact_gather import gather_compact_rows, k2_takes


def rotate_moved_rows(q8: torch.Tensor, sc: torch.Tensor, delta: torch.Tensor,
                      rope: rope_ops.RopeLanes
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Re-rotate rows that MOVED (delta < 0) by their slot delta and
    requantize them; unmoved rows return bit-exact.

    q8: int8 [..., H, D]; sc: [..., H]; delta: int [..., H] (<= 0).
    ``rope`` (``ops/rope.rope_lanes``): the lanes that carry a rotation
    and their frequencies; the other lanes of a moved row keep their
    values, and the whole row is requantized (its scale spans every
    lane).  The angle is the f32 ``pos * inv_freq`` of the tables."""
    moved = delta < 0
    scf = sc.to(torch.float32)
    x = q8.to(torch.float32) * scf[..., None]
    ang = (-delta).to(torch.float32)[..., None] * rope.inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    cc, ss = torch.cos(ang), torch.sin(ang)
    xr = x[..., rope.first:] if rope.first else x
    half = xr.shape[-1] // 2
    rot = torch.cat([-xr[..., half:], xr[..., :half]], dim=-1)
    xr = xr * cc - rot * ss
    if rope.first:
        xr = torch.cat([x[..., :rope.first], xr], dim=-1)
    q8r, sc_new = qz.quantize_rows(xr)
    q8_out = torch.where(moved[..., None], q8r, q8)
    sc_out = torch.where(moved, sc_new, scf).to(sc.dtype)
    return q8_out, sc_out


def _pack_unit_msb(q8_units: torch.Tensor, u: int) -> torch.Tensor:
    """Pack whole pack-units of tokens [B, n*u, F] -> [B, n*u//2, F]."""
    b, t, f = q8_units.shape
    units = q8_units.reshape(b, t // u, u, f)
    hi = qz._nibble(units[:, :, : u // 2])
    lo = qz._nibble(units[:, :, u // 2:])
    return ((hi << 4) | lo).reshape(b, t // 2, f)


def _pack_unit_lsb2(q8_units: torch.Tensor, u: int) -> torch.Tensor:
    """Pack whole pack-units of tokens [B, n*u, F] -> [B, n*u//4, F]."""
    b, t, f = q8_units.shape
    qr = u // 4
    f2 = (q8_units.reshape(b, t // u, u, f).to(torch.int32) >> 2) & 0x3
    out = torch.zeros((b, t // u, qr, f), dtype=torch.int32,
                      device=q8_units.device)
    for qi in range(4):
        out = out | (f2[:, :, qi * qr:(qi + 1) * qr] << (6 - 2 * qi))
    return out.to(torch.uint8).reshape(b, t // 4, f)


def compact_layer(
    cache: LayerKVCache,                 # one layer, planes [B, C(/2), F]
    imp: Optional[torch.Tensor],         # [B, Hkv, C] or None
    keep_idx: torch.Tensor,              # [B, Hkv, keep_max] ascending;
                                         #   identity rows for untriggered
    *,
    rotate_k: bool,                      # cached-rope mode: re-rotate K
    rope: Optional[rope_ops.RopeLanes],  # rotated lanes; None: rotate_k off
    lengths: Optional[torch.Tensor] = None,     # [B] live tokens
    triggered: Optional[torch.Tensor] = None,   # [B]; False rows identity
    keep_count: Optional[torch.Tensor] = None,  # [B] live keep entries
    window: Optional[int] = None,        # static bound on keep positions
    use_gather_kernel: Optional[bool] = None,   # None: K2 where it takes d
) -> tuple[LayerKVCache, Optional[torch.Tensor]]:
    """Compact one layer's planes to ``keep_idx`` IN PLACE.

    Returns (cache, imp) -- the same tensors, updated -- with the kept
    tokens moved to the front of every plane.  ``rope``: the rotated lanes
    of the model's cached row (``ops/rope.rope_lanes``), which a moved
    row is re-rotated by where ``rotate_k``; None only without it.  ``imp`` may hold more rows per token
    than the planes hold heads (one per query head of a latent cache);
    each follows its token."""
    kq, vq = cache.k, cache.v
    b, cap, f = kq.full.shape
    h = kq.heads
    d = f // h
    dev = kq.full.device
    keep_max = keep_idx.shape[-1]
    u = qz.pack_unit(cap)
    keep_pad = -(-keep_max // u) * u
    if keep_pad > cap:
        raise ValueError(f"keep_max {keep_max} pads past capacity {cap}")
    win = cap if window is None else min(window, cap)
    if win % u or win < keep_pad:
        win = cap
    if use_gather_kernel is None:
        use_gather_kernel = kq.full.is_cuda and k2_takes(d)

    keep_idx = keep_idx.to(torch.int64)
    if keep_pad > keep_max:
        # identity padding: slots [keep_max, keep_pad) copy themselves
        # (delta 0, bit-exact); zero padding would clobber live rows of
        # untriggered sequences
        pad = torch.arange(keep_max, keep_pad, device=dev).expand(
            b, h, keep_pad - keep_max)
        kidx = torch.cat([keep_idx, pad], dim=-1)
    else:
        kidx = keep_idx
    new_slot = torch.arange(keep_pad, device=dev)
    delta = torch.clamp(new_slot[None, None, :] - kidx, max=0)   # [B,H,kp]

    # ---- metadata: one sort over (position key) carries ksc, vsc, imp --
    if keep_count is not None:
        validk = (torch.arange(keep_max, device=dev)[None, None, :]
                  < keep_count[:, None, None])
        scat_idx = torch.where(validk, keep_idx, win)
    else:
        scat_idx = keep_idx
    keepm = torch.zeros((b, h, win + 1), dtype=torch.bool, device=dev)
    keepm.scatter_(2, torch.clamp(scat_idx, max=win), True)
    keepm = keepm[..., :win]                          # out-of-window dropped
    pos_c = torch.arange(win, device=dev).expand(b, h, win)
    order = torch.argsort(torch.where(keepm, pos_c, win + pos_c), dim=-1)
    trig = (None if triggered is None
            else triggered.to(torch.bool)[:, None, None])

    def prefix(plane):
        o = order if plane.shape[1] == h else order.expand(
            b, plane.shape[1], win)
        srt = torch.gather(plane[..., :win], -1, o)[..., :keep_pad]
        if keep_pad > keep_max:
            srt = torch.cat([srt[..., :keep_max],
                             plane[..., keep_max:keep_pad]], dim=-1)
        if trig is not None:
            srt = torch.where(trig, srt, plane[..., :keep_pad])
        return srt

    ksc_pref = prefix(kq.scale)
    vsc_pref = prefix(vq.scale)
    imp_pref = prefix(imp) if imp is not None else None

    # ---- payload ----------------------------------------------------------
    gidx = kidx.transpose(1, 2)[..., None].expand(b, keep_pad, h, d)
    if use_gather_kernel:
        if lengths is None:
            lengths = torch.full((b,), cap, dtype=torch.int32, device=dev)
        if triggered is None:
            triggered = torch.ones((b,), dtype=torch.int32, device=dev)
        gather_compact_rows(kq.full, vq.full, keep_idx, lengths, triggered,
                            keep_count=keep_count, window=win)
        kc = kq.full[:, :keep_pad].reshape(b, keep_pad, h, d)
        vc = None
    else:
        kc = torch.gather(kq.full.view(b, cap, h, d), 1, gidx)
        vc = torch.gather(vq.full.view(b, cap, h, d), 1, gidx)
    ksc_c = ksc_pref
    if rotate_k:
        if rope is None:
            raise ValueError("rotate_k needs the model's rope lanes")
        kc, ksc_t = rotate_moved_rows(kc, ksc_pref.transpose(1, 2),
                                      delta.transpose(1, 2), rope)
        ksc_c = ksc_t.transpose(1, 2)
    if rotate_k or not use_gather_kernel:
        kq.full[:, :keep_pad] = kc.reshape(b, keep_pad, f)
    if vc is not None:
        vq.full[:, :keep_pad] = vc.reshape(b, keep_pad, f)
    kq.scale[..., :keep_pad] = ksc_c.to(kq.scale.dtype)
    vq.scale[..., :keep_pad] = vsc_pref
    for q in (kq, vq):
        if q.msb is not None:
            q.msb[:, :keep_pad // 2] = _pack_unit_msb(q.full[:, :keep_pad], u)
        if q.lsb2 is not None:
            q.lsb2[:, :keep_pad // 4] = _pack_unit_lsb2(
                q.full[:, :keep_pad], u)
    if imp is not None:
        imp[..., :keep_pad] = imp_pref
    return cache, imp
