"""Two-plane progressive KV quantization over the token-major layout.

Port of ``spatten_tpu/ops/quantize.py``; the planes it produces match the
JAX package byte for byte, because the decode kernel scores raw packed
bytes.

* ``full`` plane: int8 ``[..., T, H*D]`` -- token-major: one contiguous row
  per token slot holding every head's vector.
* ``msb`` plane: the arithmetic-shift-right-4 nibble of the int8 value,
  biased by +8 and packed two tokens per byte into uint8
  ``[..., T//2, H*D]``.
* ``scale``: f32 ``[..., H, T]`` symmetric per-(token, head) scale.

Packing layout ("block-local split-token"): tokens pack in units of
``U = pack_unit(T)`` consecutive tokens -- packed row ``u*U/2 + r`` holds
the MSB nibble of token ``u*U + r`` in its high bits and of token
``u*U + U/2 + r`` in its low bits.

Functions that write a cache (``update_token``) update the given planes
IN PLACE and return them: the input planes are consumed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

# Midpoint correction for MSB-only dequantization: the int8 value lies in
# [msb*16, msb*16 + 15]; the interval midpoint halves the truncation bias.
MSB_MIDPOINT = 7.5
# Same for a 6-bit pass-1 value: int8 in [k6*4, k6*4 + 3].
MIDPOINT6 = 1.5


class QuantizedKV(NamedTuple):
    """A quantized K or V tensor with its bit-sliced planes (token-major).

    full:  int8  [..., T, H*D]
    msb:   uint8 [..., T//2, H*D]  biased nibbles n = (full >> 4) + 8, or
                                   None when progressive quantization is off
    scale: f32   [..., H, T]       per-(token, head) scale
    lsb2:  uint8 [..., T//4, H*D]  packed bits 3:2 of the int8 (6-bit
                                   profiles only), or None
    """

    full: torch.Tensor
    msb: Optional[torch.Tensor]
    scale: torch.Tensor
    lsb2: Optional[torch.Tensor] = None

    @property
    def tokens(self) -> int:
        return self.full.shape[-2]

    @property
    def heads(self) -> int:
        return self.scale.shape[-2]

    @property
    def head_dim(self) -> int:
        return self.full.shape[-1] // self.scale.shape[-2]

    def layer(self, l: int) -> "QuantizedKV":
        """Views of layer ``l`` of layer-stacked planes (writes go through
        to the stacked planes)."""
        return QuantizedKV(*(None if x is None else x[l] for x in self))


def _nibble(q8: torch.Tensor) -> torch.Tensor:
    """Biased MSB nibble ``n = k4 + 8`` of an int8 value, uint8 in [0, 15]."""
    nib = (q8.to(torch.int32) >> 4) & 0xF
    return (nib ^ 8).to(torch.uint8)


def pack_unit(tokens: int, target: int = 1024) -> int:
    """Token span of one nibble-split unit."""
    half = tokens // 2
    nb = max(1, -(-half // target))
    while half % nb:
        nb += 1
    return 2 * (half // nb)


def pack_msb(q8: torch.Tensor) -> torch.Tensor:
    """Pack MSB nibbles of int8 [..., T, F] into uint8 [..., T//2, F]."""
    t, f = q8.shape[-2:]
    if t % 2:
        raise ValueError("token dim must be even for nibble packing")
    u = pack_unit(t)
    units = q8.reshape(q8.shape[:-2] + (t // u, u, f))
    hi = _nibble(units[..., : u // 2, :])
    lo = _nibble(units[..., u // 2:, :])
    return ((hi << 4) | lo).reshape(q8.shape[:-2] + (t // 2, f))


def unpack_msb(packed: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 [..., T//2, F] to signed 4-bit values int8 [..., T, F]."""
    h, f = packed.shape[-2:]
    u = pack_unit(2 * h)
    p = packed.reshape(packed.shape[:-2] + (2 * h // u, u // 2, f)
                       ).to(torch.int32)
    hi = (p >> 4) - 8
    lo = (p & 0xF) - 8
    out = torch.cat([hi, lo], dim=-2)
    return out.reshape(packed.shape[:-2] + (2 * h, f)).to(torch.int8)


def pack_lsb2(q8: torch.Tensor) -> torch.Tensor:
    """Pack bits 3:2 of int8 [..., T, F] into uint8 [..., T//4, F]: within
    each ``U = pack_unit(T)`` unit, packed row ``r`` holds token
    ``u*U + q*U/4 + r`` in bits ``[7-2q : 6-2q]``."""
    t, f = q8.shape[-2:]
    if t % 4:
        raise ValueError("token dim must be a multiple of 4 for 2-bit packing")
    u = pack_unit(t)
    qr = u // 4
    units = q8.reshape(q8.shape[:-2] + (t // u, u, f)).to(torch.int32)
    f2 = (units >> 2) & 0x3
    out = torch.zeros(q8.shape[:-2] + (t // u, qr, f), dtype=torch.int32,
                      device=q8.device)
    for qi in range(4):
        out = out | (f2[..., qi * qr:(qi + 1) * qr, :] << (6 - 2 * qi))
    return out.to(torch.uint8).reshape(q8.shape[:-2] + (t // 4, f))


def unpack_lsb2(packed: torch.Tensor) -> torch.Tensor:
    """Unpack uint8 [..., T//4, F] to unsigned 2-bit values int8 [..., T, F]."""
    h, f = packed.shape[-2:]
    u = pack_unit(4 * h)
    qr = u // 4
    p = packed.reshape(packed.shape[:-2] + (4 * h // u, qr, f)
                       ).to(torch.int32)
    parts = [((p >> (6 - 2 * qi)) & 0x3) for qi in range(4)]
    out = torch.cat(parts, dim=-2)
    return out.reshape(packed.shape[:-2] + (4 * h, f)).to(torch.int8)


def to_token_major(x_hm: torch.Tensor) -> torch.Tensor:
    """[..., H, T, D] -> [..., T, H*D]."""
    h, t, d = x_hm.shape[-3:]
    return x_hm.movedim(-3, -2).reshape(x_hm.shape[:-3] + (t, h * d))


def to_head_major(fused: torch.Tensor, heads: int) -> torch.Tensor:
    """[..., T, H*D] -> [..., H, T, D]."""
    t, f = fused.shape[-2:]
    split = fused.reshape(fused.shape[:-2] + (t, heads, f // heads))
    return split.movedim(-2, -3)


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization over the last axis: (q8, scale)."""
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not the IEEE quotient JAX and
    # the kernels compute (scales would differ in the last bit)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q8 = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127
                     ).to(torch.int8)
    return q8, scale


def quantize(x: torch.Tensor, with_msb: bool = True, with_lsb2: bool = False
             ) -> QuantizedKV:
    """Symmetric int8 quantization of head-major input [..., H, T, D]."""
    q8, scale = quantize_rows(x)
    fused = to_token_major(q8)
    return QuantizedKV(full=fused,
                       msb=pack_msb(fused) if with_msb else None,
                       scale=scale,
                       lsb2=pack_lsb2(fused) if with_lsb2 else None)


def dequantize_full(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """-> head-major [..., H, T, D]."""
    hm = to_head_major(q.full, q.heads).to(torch.float32)
    return (hm * q.scale.to(torch.float32)[..., None]).to(dtype)


def dequantize_msb(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """Dequantize from the 4-bit plane only (pass-1 approximation).
    -> head-major [..., H, T, D]."""
    v4 = to_head_major(unpack_msb(q.msb), q.heads).to(torch.float32)
    return ((v4 * 16.0 + MSB_MIDPOINT)
            * q.scale.to(torch.float32)[..., None]).to(dtype)


def dequantize_6bit(q: QuantizedKV, dtype=torch.float32) -> torch.Tensor:
    """Dequantize the 6-bit value k6 = (msb << 2) | lsb2 == full >> 2.
    -> head-major [..., H, T, D]."""
    if q.lsb2 is None:
        raise ValueError("6-bit profile requires the lsb2 plane")
    v4 = to_head_major(unpack_msb(q.msb), q.heads).to(torch.float32)
    l2 = to_head_major(unpack_lsb2(q.lsb2), q.heads).to(torch.float32)
    v6 = v4 * 4.0 + l2
    return ((v6 * 4.0 + MIDPOINT6)
            * q.scale.to(torch.float32)[..., None]).to(dtype)


def msb_reference_values(q8: torch.Tensor) -> torch.Tensor:
    """int8 -> the float the 4-bit MSB pass sees (no packing)."""
    return (q8.to(torch.int32) >> 4).to(torch.float32) * 16.0 + MSB_MIDPOINT


def pass1_reference_values(q8: torch.Tensor, bits: int) -> torch.Tensor:
    """int8 -> the float a ``bits``-wide pass 1 sees (no packing)."""
    if bits >= 8:
        return q8.to(torch.float32)
    if bits == 6:
        return (q8.to(torch.int32) >> 2).to(torch.float32) * 4.0 + MIDPOINT6
    return msb_reference_values(q8)


def update_token(q: QuantizedKV, x_new: torch.Tensor, index: torch.Tensor,
                 rows: Optional[torch.Tensor] = None) -> QuantizedKV:
    """Write one new token row per sequence into slot ``index[b]``, IN
    PLACE (the input planes are consumed and returned).

    q planes: [B, T(/2,/4), H*D], scale [B, H, T]; x_new: [B, H, D]
    unquantized; index: int [B].  ``rows`` (int64 batch indices): write
    only those sequences (the others keep every byte).  The packed-plane
    write is a read-modify-write of one byte row touching only the nibble
    owned by ``index`` (the batched form of the JAX
    ``vmap(update_token)``).
    """
    t = q.tokens
    index = index.to(torch.int64)
    if rows is None:
        bi = torch.arange(x_new.shape[0], device=x_new.device)
    else:
        bi, x_new, index = rows, x_new[rows], index[rows]
    b = x_new.shape[0]
    q8_new, scale_new = quantize_rows(x_new)              # [B, H, D], [B, H]
    fused_row = q8_new.reshape(b, q.full.shape[-1])       # [B, H*D]
    q.full[bi, index] = fused_row
    hi_ = torch.arange(q.heads, device=x_new.device)
    q.scale[bi[:, None], hi_[None, :], index[:, None]] = \
        scale_new.to(q.scale.dtype)
    if q.msb is None and q.lsb2 is None:
        return q
    u = pack_unit(t)
    r_u = index % u
    if q.msb is not None:
        is_hi = (r_u < u // 2)[:, None]
        row = (index // u) * (u // 2) + (r_u % (u // 2))
        old = q.msb[bi, row]                              # [B, H*D]
        nib = _nibble(fused_row)
        q.msb[bi, row] = torch.where(is_hi, (nib << 4) | (old & 0x0F),
                                     (old & 0xF0) | nib)
    if q.lsb2 is not None:
        qr4 = u // 4
        qi = r_u // qr4
        qrow = (index // u) * qr4 + (r_u % qr4)
        old2 = q.lsb2[bi, qrow].to(torch.int32)
        f2 = (fused_row.to(torch.int32) >> 2) & 0x3
        shift = (6 - 2 * qi).to(torch.int32)[:, None]
        mask = torch.bitwise_left_shift(torch.full_like(shift, 3), shift)
        new2 = (old2 & ~mask) | torch.bitwise_left_shift(f2, shift)
        q.lsb2[bi, qrow] = new2.to(torch.uint8)
    return q


def gather_tokens(q: QuantizedKV, indices: torch.Tensor) -> QuantizedKV:
    """Rebuild a QuantizedKV keeping ``indices`` along the token axis.

    indices: [..., H, T_new] per-head kept slots; the nibble planes
    re-pack.  Returns new tensors (the input is not modified).
    """
    heads = q.heads
    full_hm = to_head_major(q.full, heads)                # [..., H, T, D]
    idx = indices.to(torch.int64)
    full_g = torch.gather(
        full_hm, -2, idx[..., None].expand(idx.shape + (full_hm.shape[-1],)))
    scale = torch.gather(q.scale, -1, idx)
    fused = to_token_major(full_g)
    return QuantizedKV(
        full=fused,
        msb=pack_msb(fused) if q.msb is not None else None,
        scale=scale,
        lsb2=pack_lsb2(fused) if q.lsb2 is not None else None)


def rotate_rows_by_delta(q: QuantizedKV, delta: torch.Tensor,
                         cos: torch.Tensor, sin: torch.Tensor) -> QuantizedKV:
    """Re-rotate each token row by its (non-positive) slot delta and
    requantize (the cached-rotated-K mode after a prune moved a row from
    p to p' <= p: R(p') = R(p' - p) R(p)).  delta: int [..., H, T];
    cos / sin: [P, D] rope tables (cos even, sin odd in the delta)."""
    x = dequantize_full(q, torch.float32)                 # [..., H, T, D]
    mag = torch.clamp(-delta.to(torch.int64), 0, cos.shape[0] - 1)
    c, s = cos[mag], -sin[mag]
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return quantize(x * c + rot * s, with_msb=q.msb is not None,
                    with_lsb2=q.lsb2 is not None)
