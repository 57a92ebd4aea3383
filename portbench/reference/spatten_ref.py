"""Plain PyTorch reference of SpAtten serving on a Llama-layout decoder.

A frozen rewrite, in float32 and with no kernel, cache layout or batching
trick, of the mathematics the port's serving path states, so that a
later change to the program cannot move the yardstick.  It imports
nothing of the program: the knobs come from the configuration file, the
weights and prompts from the harness, and every table (RoPE angles,
layer budgets, capacity rungs, V budgets) is worked out here again.
Each function names the port function it copies and how it departs.

What the reference keeps of the stated algorithm: the int8 KV cache with
one scale per (token, head) stored in bfloat16, keys stored rotated at
their slot and re-rotated when a prune moves them, the 4-bit pass-1
scores with the requant to int8 for a head whose top probability falls
below the threshold, the bfloat16 importance accumulator, cascade token
pruning at each layer's capacity rung, V pruning by blocks, head masks.
What it leaves to the program's precision: activations and weights run
in float32 here (the program: bfloat16), queries stay float32 (the
program's K1 quantizes them to int8), P·V sums float32 weights (K1:
8-bit weights on the int8 rows), probabilities stay float32 (K1 stores
them in bfloat16).  The serving head mask is the one input taken from
the program's run: it is derived from the importance of every slot of
the arena, which a reference of a few requests cannot see; the harness
checks that derivation on its own (``head_mask_from_importance``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

F32 = torch.float32
NEG_INF = float("-inf")
MSB_MIDPOINT = 7.5          # ops/quantize.py: a nibble's interval midpoint


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 and back (a value stored as the config states)."""
    return x.to(torch.bfloat16).to(F32)


@dataclass(frozen=True)
class Knobs:
    """The model's sizes and SpAtten's settings, from the config file.

    Budgets, keep bounds, rungs and V budgets are worked out as
    ``pruning/token_pruning.py`` (``layer_budgets_static``,
    ``layer_keep_max_static``, ``layer_capacities``) and
    ``models/transformer.py`` (``v_keep_budgets``) define them."""

    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    eps: float
    theta: float
    cap: int
    chunk: int
    start: int
    recent: int
    budgets: tuple
    rungs: tuple
    v_keep: tuple
    v_block: int
    requant: float
    ema: float
    imp_bf16: bool
    scale_bf16: bool

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads

    @staticmethod
    def from_config(c: dict) -> "Knobs":
        s, e = c["spatten"], c["engine"]
        layers = c["num_hidden_layers"]
        heads = c["num_attention_heads"]
        head_dim = c.get("head_dim") or c["hidden_size"] // heads
        cap = e["cache_capacity"]
        vb = s["v_block_size"]
        ratios = list(s["cascade_layer_ratios"])
        ratios += [ratios[-1]] * max(0, layers - len(ratios))
        budgets = tuple(max(vb, int(round(s["important_size"] * ratios[l])))
                        for l in range(layers))
        keep_max = [s["start_size"] + b + s["recent_size"] for b in budgets]
        headroom = max(e["layer_cap_headroom"], e["prefill_chunk"],
                       e["decode_window"])
        if e["layer_cap_rungs"] and cap % 2048 == 0 and cap >= 4096:
            rungs = tuple(min(cap, -(-(k + headroom) // 2048) * 2048)
                          for k in keep_max)
        else:
            rungs = (cap,) * layers
        if s["enable_v_pruning"]:
            v_keep = tuple(max(vb, int(s["v_keep_ratio"] * k))
                           for k in keep_max)
        else:
            v_keep = (0,) * layers
        return Knobs(
            layers=layers, heads=heads,
            kv_heads=c["num_key_value_heads"], head_dim=head_dim,
            eps=c["rms_norm_eps"], theta=c["rope_theta"], cap=cap,
            chunk=e["prefill_chunk"], start=s["start_size"],
            recent=s["recent_size"], budgets=budgets, rungs=rungs,
            v_keep=v_keep, v_block=vb,
            requant=(s["requant_threshold"] if s["quant_enabled"]
                     and s["enable_requant"] else 0.0),
            ema=s["importance_ema"],
            imp_bf16=s["importance_dtype"] == "bfloat16",
            scale_bf16=s["scale_dtype"] == "bfloat16")

    def keep_blocks(self, l: int) -> int:
        """Layer ``l``'s kept V blocks, or 0 for no V pruning
        (``ops/fused_decode._v_keep_blocks``: on where any layer's budget
        prunes within this layer's window)."""
        nvb = self.rungs[l] // self.v_block
        if not any(0 < x and max(1, -(-x // self.v_block)) < nvb
                   for x in self.v_keep):
            return 0
        return max(1, -(-self.v_keep[l] // self.v_block))


# ---------------------------------------------------------------- pieces
def rope_inv_freq(k: Knobs, device) -> torch.Tensor:
    """``ops/rope.rope_table``'s frequencies."""
    return 1.0 / (k.theta ** (torch.arange(0, k.head_dim, 2, dtype=F32,
                                           device=device) / k.head_dim))


def rotate(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor,
           sign: float = 1.0) -> torch.Tensor:
    """Rotate x [..., D] by the angle ``sign * pos * inv_freq`` ([...],
    ``ops/rope.apply_rope``'s rotate-half convention; sign -1 undoes a
    rotation, as ``pruning/compact.rotate_moved_rows`` re-rotates)."""
    ang = pos.to(F32)[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * torch.cos(ang) + rot * (sign * torch.sin(ang))


def quant_rows(x: torch.Tensor, scale_bf16: bool):
    """Symmetric int8 over the last axis (``ops/quantize.quantize_rows``):
    (int8 values as f32, the scale as stored)."""
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127)
    return q, (_bf16(scale) if scale_bf16 else scale)


def msb_values(q: torch.Tensor) -> torch.Tensor:
    """The value a 4-bit pass 1 reads for int8 ``q``: the top nibble's
    interval midpoint (``ops/quantize.msb_reference_values``)."""
    return torch.floor(q / 16.0) * 16.0 + MSB_MIDPOINT


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


class Cache:
    """The reference's KV cache of ``rows`` sequences, head-major
    [L][rows, H, C, D]: int8 values (as f32) with their stored scales,
    their dequantized rows (full and 4-bit), the importance accumulator
    and each layer's live length."""

    def __init__(self, k: Knobs, rows: int, device):
        L, H, C, D = k.layers, k.kv_heads, k.cap, k.head_dim
        z = lambda *s: torch.zeros(s, dtype=F32, device=device)  # noqa: E731
        self.kq = [torch.zeros((rows, H, C, D), dtype=torch.int8,
                               device=device) for _ in range(L)]
        self.ksc = [torch.ones(rows, H, C, device=device) for _ in range(L)]
        self.vfull = [z(rows, H, C, D) for _ in range(L)]
        self.vsc = [torch.ones(rows, H, C, device=device) for _ in range(L)]
        self.kfull = [z(rows, H, C, D) for _ in range(L)]
        self.kmsb = [z(rows, H, C, D) for _ in range(L)]
        self.imp = [z(rows, H, C) for _ in range(L)]
        self.lens = np.zeros((L, rows), dtype=np.int64)     # on the host
        self.lens_dev = torch.zeros((L, rows), dtype=torch.int64,
                                    device=device)         # its mirror

    def clear(self) -> "Cache":
        """Empty every row again (lengths 0; the planes' bytes past a
        length are never read)."""
        for imp in self.imp:
            imp.zero_()
        self.lens[:] = 0
        self.lens_dev.zero_()
        return self

    def copy_row(self, row: int, src: "Cache", src_row: int) -> None:
        """Row ``src_row`` of ``src`` into row ``row`` of this cache."""
        for name in ("kq", "ksc", "kfull", "kmsb", "vfull", "vsc", "imp"):
            for dst, got in zip(getattr(self, name), getattr(src, name)):
                dst[row] = got[src_row]
        self.lens[:, row] = src.lens[:, src_row]
        self.lens_dev[:, row] = src.lens_dev[:, src_row]

    def load(self, row: int, start: dict) -> None:
        """Take a sequence's cache as the program held it: ``k8`` / ``v8``
        int8 [L, C, H*D] (token-major), ``ksc`` / ``vsc`` / ``imp`` [L, H,
        C] as stored, ``lens`` int [L] (the reference follows the program
        from this state; see ``judge``)."""
        H = self.imp[0].shape[1]
        for l in range(len(self.kq)):
            def head_major(x):
                c, f = x.shape[-2:]
                return x.to(self.imp[l].device).reshape(
                    c, H, f // H).transpose(0, 1)
            kq = head_major(start["k8"][l])
            vq = head_major(start["v8"][l]).to(F32)
            ks = start["ksc"][l].to(self.imp[l].device, F32)
            vs = start["vsc"][l].to(self.imp[l].device, F32)
            self.kq[l][row] = kq
            self.ksc[l][row] = ks
            self.kfull[l][row] = kq.to(F32) * ks[..., None]
            self.kmsb[l][row] = msb_values(kq.to(F32)) * ks[..., None]
            self.vfull[l][row] = vq * vs[..., None]
            self.vsc[l][row] = vs
            self.imp[l][row] = start["imp"][l].to(self.imp[l].device, F32)
        lens = np.asarray(start["lens"], dtype=np.int64)
        self.lens[:, row] = lens
        self.lens_dev[:, row] = torch.from_numpy(lens).to(
            self.lens_dev.device)

    def write(self, l: int, rows: torch.Tensor, slots: torch.Tensor,
              kx: torch.Tensor, vx: torch.Tensor, scale_bf16: bool) -> None:
        """Quantize keys / values kx, vx [n, H, D] into (rows[i], :,
        slots[i]) (``ops/quantize.update_token`` / ``_append_rows``)."""
        kq, ks = quant_rows(kx, scale_bf16)
        vq, vs = quant_rows(vx, scale_bf16)
        self.kq[l][rows, :, slots] = kq.to(torch.int8)
        self.ksc[l][rows, :, slots] = ks
        self.kfull[l][rows, :, slots] = kq * ks[..., None]
        self.kmsb[l][rows, :, slots] = msb_values(kq) * ks[..., None]
        self.vfull[l][rows, :, slots] = vq * vs[..., None]
        self.vsc[l][rows, :, slots] = vs


def prune_layer(k: Knobs, cache: Cache, l: int, rows: list[int],
                inv_freq: torch.Tensor) -> None:
    """Cascade prune of layer ``l`` for sequences ``rows`` (``engine/
    generate.maybe_prune`` with ``token_pruning.select_keep_indices_
    budgeted`` and ``pruning/compact.compact_layer``): keep the first
    ``start`` tokens, the layer's ``budget`` most important of the middle
    (ties to the lower slot, as the stable sort takes them) and the last
    ``recent``; move them to the front in order; re-rotate each moved key
    by its slot delta and requantize it.  Importance follows its token;
    the slots from the keep count up to the layer's static keep bound
    take the importance of the dropped tokens in slot order, and the rest
    keep theirs (compact_layer's prefix sort), since a dead head group's
    next appended token reads that slot as it stands."""
    budget = k.budgets[l]
    keep_max = k.start + budget + k.recent
    win = k.rungs[l]
    dev = cache.imp[l].device
    for b in rows:
        n = int(cache.lens[l, b])
        rb = n - k.recent
        n_imp = min(budget, max(rb - k.start, 0))
        count = k.start + n_imp + k.recent
        imp = cache.imp[l][b]                                   # [H, C]
        pos = torch.arange(win, device=dev)
        middle = (pos >= k.start) & (pos < rb)
        masked = torch.where(middle, imp[:, :win], NEG_INF)
        top = torch.sort(masked, dim=-1, descending=True,
                         stable=True).indices[:, :n_imp]
        kept = torch.cat([
            torch.arange(k.start, device=dev).expand(k.kv_heads, k.start),
            torch.sort(top, dim=-1).values,
            (rb + torch.arange(k.recent, device=dev)).expand(k.kv_heads,
                                                             k.recent)],
            dim=-1)                                             # [H, count]
        hi = torch.arange(k.kv_heads, device=dev)[:, None]
        delta = torch.arange(count, device=dev)[None] - kept    # <= 0
        # keys: moved rows re-rotated and requantized, others exact
        kq = cache.kq[l][b][hi, kept].to(F32)                   # [H, n, D]
        ks = cache.ksc[l][b][hi, kept]
        x = kq * ks[..., None]
        xr = rotate(x, delta.to(F32), inv_freq)                 # delta < 0
        q2, s2 = quant_rows(xr, k.scale_bf16)
        moved = (delta < 0)
        kq = torch.where(moved[..., None], q2, kq)
        ks = torch.where(moved, s2, ks)
        cache.kq[l][b, :, :count] = kq.to(torch.int8)
        cache.ksc[l][b, :, :count] = ks
        cache.kfull[l][b, :, :count] = kq * ks[..., None]
        cache.kmsb[l][b, :, :count] = msb_values(kq) * ks[..., None]
        cache.vfull[l][b, :, :count] = cache.vfull[l][b][hi, kept]
        cache.vsc[l][b, :, :count] = cache.vsc[l][b][hi, kept]
        # importance: kept first, then the dropped slots in order
        keepm = torch.zeros((k.kv_heads, win), dtype=torch.bool, device=dev)
        keepm[hi, kept] = True
        order = torch.argsort(torch.where(keepm, pos, win + pos), dim=-1)
        upto = min(keep_max, win)
        cache.imp[l][b, :, :upto] = torch.gather(imp[:, :win], -1,
                                                 order)[:, :upto]
        cache.lens[l, b] = count
        cache.lens_dev[l, b] = count


# ------------------------------------------------------------- the model
E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (its largest magnitude maps to the format's largest), back in f32."""
    amax = x.abs().amax(dim=dim, keepdim=True)
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(F32) * scale


class Reference:
    """The reference decoder over float32 copies of the weights.

    ``precision`` "fp8" computes every matrix product in float8 e4m3
    instead (weights rounded once, one scale per output channel; each
    product's input rounded per row): the control, a precision below the
    configuration's bfloat16, which the benchmark's runs never use."""

    def __init__(self, knobs: Knobs, params: dict, device,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.k = knobs
        self.dev = torch.device(device)
        self.fp8 = precision == "fp8"
        f = lambda t: t.to(device=self.dev, dtype=F32)  # noqa: E731
        lay = params["layers"]
        mats = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
        self.w = {name: f(lay[name]) for name in
                  ("attn_norm_w", "mlp_norm_w") + mats}
        self.embed = f(params["embed"])
        self.final_norm = f(params["final_norm_w"])
        self.lm_head = f(params["lm_head"])
        if self.fp8:
            for name in mats:
                self.w[name] = fp8_round(self.w[name], dim=-2)
            self.lm_head = fp8_round(self.lm_head, dim=-2)
        self.inv_freq = rope_inv_freq(knobs, self.dev)

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x @ w, its input rounded to e4m3 per row under "fp8"."""
        return (fp8_round(x, dim=-1) if self.fp8 else x) @ w

    # -- one layer's projections -----------------------------------------
    def _qkv(self, l: int, x: torch.Tensor, pos: torch.Tensor):
        """x [n, S, hidden]; pos [n, S] -> rotated q [n, Hq, S, D], rotated
        k and v [n, H, S, D] (``models/transformer.run_layers.qkv``, keys
        rotated at their slot: rope_mode "cached")."""
        k = self.k
        n, s, _ = x.shape
        h = rms_norm(x, self.w["attn_norm_w"][l], k.eps)
        q = self.mm(h, self.w["wq"][l]).reshape(n, s, k.heads, k.head_dim)
        kk = self.mm(h, self.w["wk"][l]).reshape(n, s, k.kv_heads, k.head_dim)
        v = self.mm(h, self.w["wv"][l]).reshape(n, s, k.kv_heads, k.head_dim)
        p = pos[:, :, None]
        q = rotate(q, p, self.inv_freq).transpose(1, 2)
        kk = rotate(kk, p, self.inv_freq).transpose(1, 2)
        return q, kk, v.transpose(1, 2)

    def _out_mlp(self, l: int, x: torch.Tensor, attn: torch.Tensor):
        """attn [n, Hq, S, D] -> the residual after o_proj and the MLP."""
        n, _, s, _ = attn.shape
        o = attn.transpose(1, 2).reshape(n, s, -1)
        x = x + self.mm(o, self.w["wo"][l])
        h = rms_norm(x, self.w["mlp_norm_w"][l], self.k.eps)
        act = torch.nn.functional.silu(self.mm(h, self.w["w_gate"][l]))
        return x + self.mm(act * self.mm(h, self.w["w_up"][l]),
                           self.w["w_down"][l])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.mm(rms_norm(x, self.final_norm, self.k.eps),
                       self.lm_head)

    # -- prefill ---------------------------------------------------------
    def prefill_chunk(self, cache: Cache, row: int, ids: torch.Tensor
                      ) -> torch.Tensor:
        """One prompt chunk ids [S] of sequence ``row``, pruning first any
        layer the chunk would overflow (``engine/generate.prefill_chunk``;
        the attention of ``ops/prefill_attention.py`` at the serving
        settings: full-precision scores over the int8 keys, no V
        pruning, the importance of every query added).  Returns the last
        token's logits [vocab]."""
        k = self.k
        s = ids.shape[0]
        for l in range(k.layers):
            if int(cache.lens[l, row]) + s > k.rungs[l]:
                prune_layer(k, cache, l, [row], self.inv_freq)
        x = self.embed[ids][None]                               # [1, S, hid]
        ar = torch.arange(s, device=self.dev)
        rows = torch.full((s,), row, device=self.dev)
        for l in range(k.layers):
            n0 = int(cache.lens[l, row])
            pos = torch.clamp(n0 + ar, max=k.cap - 1)
            q, kk, v = self._qkv(l, x, pos[None])
            cache.write(l, rows, n0 + ar, kk[0].transpose(0, 1),
                        v[0].transpose(0, 1), k.scale_bf16)
            n = n0 + s
            keys = cache.kfull[l][row, :, :n]                   # [H, n, D]
            qg = q[0].reshape(k.kv_heads, k.group, s, k.head_dim)
            sc = torch.einsum("hgsd,hcd->hgsc", qg, keys) / math.sqrt(
                k.head_dim)
            causal = torch.arange(n, device=self.dev)[None] <= pos[:, None]
            sc = torch.where(causal, sc, NEG_INF)
            p = torch.softmax(sc, dim=-1)                       # [H, g, S, n]
            imp = cache.imp[l][row]
            new = (torch.arange(k.cap, device=self.dev) >= n0) & (
                torch.arange(k.cap, device=self.dev) < n)
            acc = torch.where(new, 0.0, imp) * k.ema
            acc[:, :n] += p.sum(dim=(1, 2))
            cache.imp[l][row] = _bf16(acc) if k.imp_bf16 else acc
            out = torch.einsum("hgsc,hcd->hgsd", p,
                               cache.vfull[l][row, :, :n])
            out = out.reshape(1, k.heads, s, k.head_dim)
            cache.lens[l, row] = n
            cache.lens_dev[l, row] = n
            x = self._out_mlp(l, x, out)
        return self.logits(x[0, -1])

    def prefill(self, cache: Cache, prompt) -> torch.Tensor:
        """A whole prompt into the one-row ``cache``, in chunks as the
        engine takes them; a chunk of one token is a decode step, since
        the model runs every single-token step through the decode kernel
        (``models/transformer.run_layers``), here with every head live
        (a new request's own state).  Returns the last logits [vocab]."""
        k = self.k
        ids = torch.as_tensor(prompt, dtype=torch.int64, device=self.dev)
        live = torch.ones((1, k.layers, k.heads), dtype=torch.bool,
                          device=self.dev)
        for s0 in range(0, ids.shape[0], k.chunk):
            part = ids[s0:s0 + k.chunk]
            if part.shape[0] == 1:
                lg = self.decode_step(cache, part, live)[0]
            else:
                lg = self.prefill_chunk(cache, 0, part)
        return lg

    # -- decode ------------------------------------------------------------
    def decode_step(self, cache: Cache, tokens: torch.Tensor,
                    head_mask: torch.Tensor) -> torch.Tensor:
        """One decode step of every row: tokens [n]; head_mask [n, L, Hq]
        bool (the serving mask in force for that row's step).  Prunes a
        layer first where the row is at its rung, then runs each layer as
        the K1 kernel's contract states it (``ops/fused_decode.py``,
        computed here as ``ops/attention_ref.spatten_attention_reference``
        computes it): append the token's quantized K/V; pass-1 scores on
        the 4-bit keys; the requant to the int8 keys for a kv head whose
        top probability (over its group, before head masking) is below
        the threshold; masked heads zeroed; the importance of the live
        columns of a live head group set to imp + the group's
        probabilities (the new slot from 0), a dead group's left as it
        is; P·V over the kept V blocks (top ``keep_blocks`` by
        probability mass per query head, ties kept), not renormalized.
        Returns logits [n, vocab]."""
        k = self.k
        nrows = tokens.shape[0]
        dev = self.dev
        for l in range(k.layers):
            due = [b for b in range(nrows)
                   if int(cache.lens[l, b]) + 1 > k.rungs[l]]
            if due:
                prune_layer(k, cache, l, due, self.inv_freq)
        x = self.embed[tokens][:, None]                         # [n, 1, hid]
        ri = torch.arange(nrows, device=dev)
        cols = torch.arange(k.cap, device=dev)
        for l in range(k.layers):
            n0 = cache.lens_dev[l].clone()                      # [n]
            pos = torch.clamp(n0, max=k.cap - 1)
            q, kk, v = self._qkv(l, x, pos[:, None])
            cache.write(l, ri, n0, kk[:, :, 0], v[:, :, 0], k.scale_bf16)
            n = n0 + 1
            live = cols[None] < n[:, None]                      # [n, C]
            qg = q[:, :, 0].reshape(nrows, k.kv_heads, k.group,
                                    k.head_dim)
            sm = 1.0 / math.sqrt(k.head_dim)

            def probs(keys):
                sc = torch.einsum("bhgd,bhcd->bhgc", qg, keys) * sm
                return torch.softmax(
                    torch.where(live[:, None, None], sc, NEG_INF), dim=-1)

            p = probs(cache.kmsb[l])                            # [n,H,g,C]
            hm = head_mask[:, l].reshape(nrows, k.kv_heads, k.group)
            alive = hm.any(-1)                                  # [n, H]
            if k.requant > 0:
                need = alive & (p.amax(dim=(-1, -2)) < k.requant)
                p = torch.where(need[..., None, None],
                                probs(cache.kfull[l]), p)
            p = p * hm[..., None]
            at = cols[None] == n0[:, None]                      # [n, C]
            imp = cache.imp[l]
            upd = live[:, None] & alive[..., None]
            new = torch.where(at[:, None], 0.0, imp) * k.ema + p.sum(2)
            new = _bf16(new) if k.imp_bf16 else new
            cache.imp[l] = torch.where(upd, new, imp)
            kb = k.keep_blocks(l)
            if kb:
                nb = k.cap // k.v_block
                mass = p.reshape(nrows, k.kv_heads, k.group, nb,
                                 k.v_block).sum(-1)
                if kb < nb:
                    kth = torch.sort(mass, dim=-1, descending=True
                                     ).values[..., kb - 1:kb]
                    keep = (mass >= kth) & (mass > 0)
                    p = p * keep.repeat_interleave(k.v_block, dim=-1)
            out = torch.einsum("bhgc,bhcd->bhgd", p, cache.vfull[l])
            cache.lens[l] += 1
            cache.lens_dev[l] += 1
            x = self._out_mlp(l, x, out.reshape(nrows, k.heads, 1,
                                                k.head_dim))
        return self.logits(x[:, 0])


def head_mask_from_importance(k: Knobs, importance: torch.Tensor,
                              lengths: torch.Tensor, keep: int):
    """The serving head mask worked out from an arena's importance
    [L, B, H, C] and nominal lengths [B] (``engine/policy.update_head_
    mask``: each kv head group's importance summed over the batch's
    columns below the nominal length; the top ``keep`` groups of a layer
    stay, ties to the lower index).  Returns (mask [L, Hq] bool, the
    per-(layer, group) sums [L, H] f32)."""
    cap = importance.shape[-1]
    valid = (torch.arange(cap, device=importance.device)[None]
             < lengths[:, None])[None, :, None, :]
    sums = torch.where(valid, importance.to(F32), 0.0).sum(dim=(1, 3))
    keep = min(keep, k.kv_heads)
    if keep <= 0 or keep >= k.kv_heads:
        gm = torch.ones_like(sums, dtype=torch.bool)
    else:
        order = torch.sort(sums, dim=-1, descending=True,
                           stable=True).indices[:, :keep]
        gm = torch.zeros_like(sums, dtype=torch.bool).scatter(-1, order,
                                                              True)
    return gm.repeat_interleave(k.group, dim=-1), sums


def judge(ref: Reference, rows: list[dict], mask_table: torch.Tensor,
          logits_out: list | None = None, batch: int = 8
          ) -> list[torch.Tensor]:
    """Replay each row's served tokens and return, per row, the gap by
    which each judged token's reference logit lies below the reference's
    best at that position (f32 [n_judged]).  ``logits_out``: a list that
    receives, per row, the reference's logits at those positions
    ([n_judged, vocab], on the CPU).

    rows: dicts with ``tokens`` (the served ids), ``masks`` (per decode
    step, an index into ``mask_table`` [M, L, Hq]) and either ``prompt``
    (int [P]: the reference prefills it, and the first served token is
    judged against the prefill's logits; decode step j then feeds token
    j and judges token j + 1) or ``start`` (a sequence's cache as
    ``Cache.load`` takes it: decode step j feeds token j and judges
    token j + 1).  Rows run ``batch`` at a time."""
    out: list[torch.Tensor] = []
    for b0 in range(0, len(rows), batch):
        part = rows[b0:b0 + batch]
        kept: list = [] if logits_out is not None else None
        out += _judge_batch(ref, part, mask_table, kept)
        if kept is not None:
            logits_out.extend(kept)
    return out


def _judge_batch(ref: Reference, rows: list[dict], mask_table, logits_out):
    k = ref.k
    dev = ref.dev
    cache = Cache(k, len(rows), dev)
    gaps: list[list[torch.Tensor]] = [[] for _ in rows]
    kept: list[list[torch.Tensor]] = [[] for _ in rows]
    one = None
    for b, r in enumerate(rows):
        if "start" in r:
            cache.load(b, r["start"])
            continue
        one = Cache(k, 1, dev) if one is None else one.clear()
        lg = ref.prefill(one, r["prompt"])
        cache.copy_row(b, one, 0)
        gaps[b].append(lg.max() - lg[int(r["tokens"][0])])
        if logits_out is not None:
            kept[b].append(lg.cpu())
    del one
    steps = max(len(r["tokens"]) for r in rows) - 1
    # every row's inputs on the device at once (a row that has ended
    # repeats its last token and mask; its logits are not read)
    width = steps + 1
    toks_all = torch.tensor([list(r["tokens"]) + [r["tokens"][-1]] * (
        width - len(r["tokens"])) for r in rows], device=dev)
    mask_ids = torch.tensor([list(r["masks"]) + [r["masks"][-1]] * (
        width - len(r["masks"])) for r in rows], device=dev)
    table = mask_table.to(dev)
    for j in range(steps):
        lg = ref.decode_step(cache, toks_all[:, j], table[mask_ids[:, j]])
        for b, r in enumerate(rows):
            if j + 1 < len(r["tokens"]):
                gaps[b].append(lg[b].max() - lg[b, toks_all[b, j + 1]])
                if logits_out is not None:
                    kept[b].append(lg[b].cpu())
    if logits_out is not None:
        logits_out.extend(torch.stack(x) for x in kept)
    del cache
    return [torch.stack(g).cpu() for g in gaps]
