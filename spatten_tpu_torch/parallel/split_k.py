"""Split-K (sequence-parallel) flash decode over a sharded KV token axis.

Port of ``spatten_tpu/parallel/split_k.py``.  The cache's token axis is
cut into ``n`` shards of ``Cl`` slots; shard ``i`` holds global slots
``[i*Cl, (i+1)*Cl)``.  Each shard computes flash-style partial attention
over its slice (a local running max ``m_i`` and denominator ``den_i``),
and the partials combine exactly:

    m   = max_i m_i
    out = sum_i exp(m_i - m) * den_i * o_i  /  sum_i exp(m_i - m) * den_i

The JAX package runs this as one ``shard_map`` program over a ``kv``
mesh axis.  Here one controller drives the shards in turn: the mesh is
an explicit list of torch devices that the caller names (a device may
repeat -- four shards on one card, or n shards on the CPU in the tests),
and JAX's ``pmax``/``psum`` become reductions over the shards' partials
on the mesh's first device.  K1 needs contiguous planes, and a token
slice of a [B, n*Cl, F] plane is not contiguous, so a sharded cache is a
list of per-shard ``QuantizedKV``s (and importance slices), each
contiguous on its own device, packed shard-locally (``pack_unit(Cl)``).
``shard_kv``/``join_kv`` convert from and to the JAX package's global
layout (the shards' planes concatenated along the token axis).

``split_k_decode_fused`` runs K1 per shard with the split-K flags: only
the shard owning slot ``glob - 1`` appends (``append_mask``), each shard
returns its flash partials (``return_row_stats``), and under GQA its
per-query-row importance deltas (``per_row_importance``), so the
importance update is exact.  On CUDA tensors every shard's attention is
a K1 launch.  Requant decisions and V-pruning budgets apply
shard-locally, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from spatten_tpu_torch.ops import quantize as qz
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.ops.attention_ref import MASK_VALUE
from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
from spatten_tpu_torch.pruning.compact import rotate_moved_rows
from spatten_tpu_torch.pruning.token_pruning import select_keep_indices


class KVMesh(NamedTuple):
    """A one-axis mesh over the token axis: shard i lives on devices[i]."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_kv_mesh(devices: Sequence) -> KVMesh:
    """A token-axis mesh over the caller's devices, in shard order."""
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return KVMesh(devs)


# ------------------------------------------------------------ layout helpers
def shard_tokens(x: torch.Tensor, mesh: KVMesh, dim: int = -1
                 ) -> list[torch.Tensor]:
    """Cut ``x`` into ``mesh.size`` equal slices along ``dim``, each a
    contiguous tensor on its shard's device."""
    n = mesh.size
    if x.shape[dim] % n:
        raise ValueError(f"axis {x.shape[dim]} does not divide over {n}")
    return [part.to(dev).contiguous()
            for part, dev in zip(torch.chunk(x, n, dim=dim), mesh.devices)]


def join_tokens(parts: Sequence[torch.Tensor], dim: int = -1,
                device=None) -> torch.Tensor:
    """Concatenate shard slices along ``dim`` on ``device`` (default: the
    first slice's)."""
    dev = parts[0].device if device is None else torch.device(device)
    return torch.cat([p.to(dev) for p in parts], dim=dim)


def _token_dim(field: str) -> int:
    """The token axis of a QuantizedKV field: scale [.., H, T], planes
    [.., T(/2,/4), F]."""
    return -1 if field == "scale" else -2


def shard_kv(q: qz.QuantizedKV, mesh: KVMesh) -> list[qz.QuantizedKV]:
    """Per-shard planes of a cache in the global shard-local-packed layout
    (planes [B, n*Cl(/2,/4), F], scale [B, H, n*Cl])."""
    parts = {f: None if x is None else shard_tokens(x, mesh, _token_dim(f))
             for f, x in zip(q._fields, q)}
    return [qz.QuantizedKV(**{f: None if p is None else p[i]
                              for f, p in parts.items()})
            for i in range(mesh.size)]


def join_kv(shards: Sequence[qz.QuantizedKV], device=None) -> qz.QuantizedKV:
    """The global layout of per-shard planes (``shard_kv``'s inverse)."""
    return qz.QuantizedKV(**{
        f: None if getattr(shards[0], f) is None else
        join_tokens([getattr(s, f) for s in shards], _token_dim(f), device)
        for f in qz.QuantizedKV._fields})


def quantize_sharded(x: torch.Tensor, mesh: KVMesh, with_msb: bool = True,
                     with_lsb2: bool = False) -> list[qz.QuantizedKV]:
    """Quantize head-major [B, H, n*Cl, D] shard by shard: each shard's
    planes are what a local ``quantize`` of its slice gives (full and
    scale equal a global quantization's, since scales are per token)."""
    return [qz.quantize(part, with_msb=with_msb, with_lsb2=with_lsb2)
            for part in shard_tokens(x, mesh, dim=-2)]


# ------------------------------------------------------------ recombination
def _combine(outs, ms, dens, dev0):
    """Exact flash recombination on ``dev0`` of per-shard normalized
    outputs [B, H, ...] and row stats [B, H]: (out, weight / den_g per
    shard [n, B, H])."""
    m = torch.stack([x.to(dev0) for x in ms])                 # [n, B, H]
    w = torch.exp(m - m.amax(0)) * torch.stack([x.to(dev0) for x in dens])
    den_g = torch.clamp(w.sum(0), min=1e-30)
    extra = (1,) * (outs[0].ndim - 2)
    num = sum(o.to(dev0) * w[i].reshape(w[i].shape + extra)
              for i, o in enumerate(outs))
    return num / den_g.reshape(den_g.shape + extra), w / den_g


def _local_partial(q, k_local, v_local, base, lengths, sm_scale):
    """Partial attention over one shard: q [B, H, D], k/v [B, H, Cl, D],
    ``base`` the global slot of local column 0.  Returns the shard's
    normalized output and its (m, den) [B, H]."""
    cl = k_local.shape[-2]
    scores = torch.einsum("bhd,bhcd->bhc", q, k_local) * sm_scale
    gcol = base + torch.arange(cl, device=q.device)[None, None, :]
    valid = gcol < lengths[:, None, None]
    scores = torch.where(valid, scores, MASK_VALUE)
    m = scores.amax(-1)
    e = torch.where(valid, torch.exp(scores - m[..., None]), 0.0)
    den = e.sum(-1)
    o = torch.einsum("bhc,bhcd->bhd", e, v_local)
    return o / torch.clamp(den, min=1e-30)[..., None], m, den


def split_k_decode(q: torch.Tensor, k_shards: Sequence[torch.Tensor],
                   v_shards: Sequence[torch.Tensor], lengths: torch.Tensor,
                   mesh: KVMesh, sm_scale: float = 1.0) -> torch.Tensor:
    """Exact decode attention with K/V [B, H, Cl, D] per shard: each shard
    computes its flash partial, and the partials combine on the first
    device.  Returns [B, H, D]."""
    cl = k_shards[0].shape[-2]
    parts = [_local_partial(q.to(dev), k, v, i * cl, lengths.to(dev),
                            sm_scale)
             for i, (dev, k, v) in enumerate(zip(mesh.devices, k_shards,
                                                 v_shards))]
    out, _ = _combine(*zip(*parts), mesh.devices[0])
    return out


def split_k_decode_fused(
    q: torch.Tensor,                       # [B, Hq, 1, D] rotated queries
    k_shards: Sequence[qz.QuantizedKV],    # per shard [B, Cl(/2,/4), F]
    v_shards: Sequence[qz.QuantizedKV],
    k_new: torch.Tensor,                   # [B, Hkv, 1, D], appended by
    v_new: torch.Tensor,                   #   the shard owning the tail
    local_lengths: torch.Tensor,           # int [n, B] live tokens per
                                           #   shard, the owner's INCL. new
    mesh: KVMesh,
    sm_scale: float = 1.0,
    importance_in: Optional[Sequence[torch.Tensor]] = None,  # [B, Hkv, Cl]
    importance_ema: float = 1.0,
    **spatten_kwargs,                      # K1 flags, applied per shard
):
    """Exact split-K decode with K1 per shard.

    The owner of a sequence's new token is shard ``(glob - 1) // Cl``; it
    alone appends.  The outputs combine exactly on the first device.
    ``importance_in`` (per-shard accumulator slices) is updated IN PLACE
    with the globally normalized probabilities: each shard's delta
    rescales by ``exp(m_i - m) * den_i / den_g`` (per query row under
    GQA, before the group sum), the appended slot starts from 0 and the
    EMA applies outside the kernel.  The cache planes are updated in
    place too.

    Returns (out [B, Hq, 1, D] on the first device, k_shards, v_shards,
    importance slices or None, max_prob [n, B, Hkv], need_requant
    [n, B, Hkv] int32).
    """
    cl = k_shards[0].tokens
    b, hq = q.shape[:2]
    hkv = k_shards[0].heads
    group = hq // hkv
    track = importance_in is not None
    dev0 = mesh.devices[0]
    outs, ms, dens, stats, appms = [], [], [], [], []
    for i, dev in enumerate(mesh.devices):
        ll = local_lengths.to(dev)
        glob = ll.sum(0)
        appm = torch.div(glob - 1, cl, rounding_mode="floor") == i
        kw = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
              for k, v in spatten_kwargs.items()}
        out, st, _, _, (m, den) = fused_decode_attention(
            q.to(dev), k_shards[i], v_shards[i], k_new.to(dev),
            v_new.to(dev), ll[i], sm_scale=sm_scale, append_mask=appm,
            return_row_stats=True, track_importance=track,
            importance_ema=1.0, per_row_importance=group > 1, **kw)
        outs.append(out)
        ms.append(m)
        dens.append(den)
        stats.append(st)
        appms.append((appm, glob))
    out_g, corr = _combine(outs, ms, dens, dev0)
    if track:
        for i, (dev, imp) in enumerate(zip(mesh.devices, importance_in)):
            rows = stats[i].importance_delta * corr[i].to(dev)[:, :, None]
            delta = rows if group == 1 else rows.reshape(
                b, hkv, group, cl).sum(2)
            prev = imp.to(torch.float32)
            if importance_ema != 1.0:
                prev = prev * importance_ema
            appm, glob = appms[i]
            col = i * cl + torch.arange(cl, device=dev)[None, None, :]
            appcol = (col == (glob - 1)[:, None, None]) & appm[:, None, None]
            prev = torch.where(appcol, 0.0, prev)
            imp.copy_((prev + delta).to(imp.dtype))
    maxp = torch.stack([st.max_prob.to(dev0) for st in stats])
    need = torch.stack([st.need_requant.to(dev0).to(torch.int32)
                        for st in stats])
    return (out_g, k_shards, v_shards,
            list(importance_in) if track else None, maxp, need)


def split_k_prune(
    k_shards: Sequence[qz.QuantizedKV],
    v_shards: Sequence[qz.QuantizedKV],
    importance: Sequence[torch.Tensor],    # per shard [B, Hkv, Cl]
    local_lengths: torch.Tensor,           # int [n, B]
    mesh: KVMesh,
    *,
    start_size: int,
    important_size: int,
    recent_size: int,
    rotate_k: bool = False,                # cached-rope mode: re-rotate
    rope_theta: float = 10000.0,           #   moved keys
    trigger: Optional[torch.Tensor] = None,  # bool [B], None = all
):
    """Cascade token pruning over a token-sharded cache.

    Selection is global (per-head top-k over the whole token axis, ties
    to the lower index); the kept rows gather on the first device (a
    plain gather, as the JAX package's ``take_along_axis``), moved keys
    re-rotate under ``rotate_k``, and the kept tokens then sit from global
    slot 0, shard i holding slots [i*Cl, (i+1)*Cl) as before.  Each
    shard's nibble planes repack shard-locally.  Untriggered sequences
    keep every byte and their local lengths.

    Returns new (k_shards, v_shards, importance slices, local_lengths
    [n, B] int32 on the first device); keep_total = start + important +
    recent live tokens.
    """
    n, dev0 = mesh.size, mesh.devices[0]
    kg, vg = join_kv(k_shards, dev0), join_kv(v_shards, dev0)
    imp = join_tokens(importance, -1, dev0)
    b, cap, f = kg.full.shape
    hkv = kg.heads
    d = f // hkv
    cl = cap // n
    ll = local_lengths.to(dev0)
    glob = ll.sum(0)
    keep_total = start_size + important_size + recent_size
    trig = (torch.ones(b, dtype=torch.bool, device=dev0) if trigger is None
            else torch.as_tensor(trigger, device=dev0).to(torch.bool))

    keep = select_keep_indices(imp.to(torch.float32), glob[:, None],
                               start_size, important_size, recent_size, 0)
    # untriggered sequences rewrite identically (the selection is only
    # meaningful when a sequence is over its budget)
    ident = torch.arange(keep_total, dtype=torch.int32,
                         device=dev0).expand(keep.shape)
    ki = torch.where(trig[:, None, None], keep, ident).to(torch.int64)

    def gather_rows(full):
        idx = ki.transpose(1, 2)[..., None].expand(b, keep_total, hkv, d)
        return torch.gather(full.reshape(b, cap, hkv, d), 1, idx).reshape(
            b, keep_total, f)

    def pad_rows(rows):
        return torch.cat([rows, torch.zeros((b, cap - keep_total, f),
                                            dtype=rows.dtype, device=dev0)],
                         dim=1)

    krows = gather_rows(kg.full)
    ksc = torch.gather(kg.scale, -1, ki)
    if rotate_k:
        # moved rows (delta < 0) re-rotate by their slot delta and
        # requantize; unmoved rows stay bit-exact
        new_slot = torch.arange(keep_total, device=dev0)
        delta = torch.clamp(new_slot[None, None, :] - ki, max=0)
        k4, sc_t = rotate_moved_rows(
            krows.reshape(b, keep_total, hkv, d), ksc.transpose(1, 2),
            delta.transpose(1, 2),
            rope_ops.RopeLanes(0, rope_ops.inv_freq(d, rope_theta, dev0)))
        krows = k4.reshape(b, keep_total, f)
        ksc = sc_t.transpose(1, 2).to(ksc.dtype)
    kf_new, vf_new = pad_rows(krows), pad_rows(gather_rows(vg.full))

    def pad_cols(g, fill, dtype):
        return torch.cat([g.to(dtype), torch.full(
            (b, hkv, cap - keep_total), fill, dtype=dtype, device=dev0)], -1)

    ksc_new = pad_cols(ksc, 1.0, kg.scale.dtype)
    vsc_new = pad_cols(torch.gather(vg.scale, -1, ki), 1.0, vg.scale.dtype)
    imp_new = pad_cols(torch.gather(imp, -1, ki), 0.0, imp.dtype)

    def merge(new_parts, old_parts):
        out = []
        for new, old in zip(new_parts, old_parts):
            t = trig.to(old.device).reshape((-1,) + (1,) * (old.ndim - 1))
            out.append(torch.where(t, new.to(old.device), old).contiguous())
        return out

    kf_s, vf_s = shard_tokens(kf_new, mesh, -2), shard_tokens(vf_new, mesh, -2)

    def planes(full_s, old, sc_new):
        # shard-local nibble repack (pack_unit(Cl) per shard)
        msb = None if old[0].msb is None else merge(
            [qz.pack_msb(x) for x in full_s], [s.msb for s in old])
        lsb2 = None if old[0].lsb2 is None else merge(
            [qz.pack_lsb2(x) for x in full_s], [s.lsb2 for s in old])
        full = merge(full_s, [s.full for s in old])
        scale = merge(shard_tokens(sc_new, mesh, -1), [s.scale for s in old])
        return [qz.QuantizedKV(full=full[i],
                               msb=None if msb is None else msb[i],
                               scale=scale[i],
                               lsb2=None if lsb2 is None else lsb2[i])
                for i in range(n)]

    k2 = planes(kf_s, k_shards, ksc_new)
    v2 = planes(vf_s, v_shards, vsc_new)
    imp2 = merge(shard_tokens(imp_new, mesh, -1), importance)
    base = torch.arange(n, device=dev0)[:, None] * cl
    local2 = torch.clamp(keep_total - base, 0, cl).expand(n, b)
    local2 = torch.where(trig[None, :], local2, ll).to(torch.int32)
    return k2, v2, imp2, local2


def reference_decode(q, k, v, lengths, sm_scale: float = 1.0
                     ) -> torch.Tensor:
    """Unsharded masked softmax attention (the tests' oracle): q [B, H, D],
    k/v [B, H, C, D]."""
    scores = torch.einsum("bhd,bhcd->bhc", q, k) * sm_scale
    valid = torch.arange(k.shape[-2], device=q.device)[None, None, :] \
        < lengths[:, None, None]
    p = torch.softmax(torch.where(valid, scores, MASK_VALUE), dim=-1)
    return torch.einsum("bhc,bhcd->bhd", torch.where(valid, p, 0.0), v)
