"""Plain PyTorch reference of SpAtten serving on DeepSeek-V2 (multi-head
latent attention and routed experts).

A frozen rewrite, in float32 and with no kernel, cache layout or batching
trick, of the mathematics the port's ``deepseek_v2`` path states, so that
a later change to the program cannot move the yardstick.  It imports
nothing of the program (the float32 helpers it shares with the Llama
reference come from ``spatten_ref.py``): the knobs come from the
configuration file, the weights and prompts from the harness, and every
table (YaRN frequencies, the softmax scale, layer budgets, V budgets) is
worked out here again from the published formulas.

The published model (``DeepseekV2Attention``, ``DeepseekV2MoE``), with
no query compression: per token ``q = h W_q`` splits into each head's
``q_nope`` and ``q_pe``; ``h W_kv_a`` into the latent ``c_kv`` (RMS-normed)
and the rope lanes ``k_pe`` shared by every head; the rope lanes are
de-interleaved and rotated at YaRN's frequencies; per head ``k = [c_kv
W_UK_h || k_pe]``, ``v = c_kv W_UV_h``, scores scaled by ``(nope +
rope)^-0.5 * mscale^2``; the heads' outputs through ``W_o``.  The MLP is
dense SwiGLU in the first ``first_k_dense_replace`` layers; after them a
softmax router in float32 picks each token's top ``num_experts_per_tok``
experts greedily, their SwiGLU outputs summed with the router's
probabilities (not renormalised) times ``routed_scaling_factor``, plus
the shared experts.  Attention is computed here in that non-absorbed
form, each head's keys and values up-projected from the cached latent
rows, which checks the program's absorption of ``W_UK`` into the query
and of ``W_UV`` after the attention on its own.

Departures from the published model, which the program makes too and
the reference follows (SpAtten's cache decisions, as ``spatten_ref.py``
follows them for the Llama layout):

- the cache holds one row ``[c_kv || rope(k_pe)]`` per token and layer,
  quantized to int8 with one bfloat16 scale over all its lanes; the keys
  and values are up-projected from the dequantized rows (4-bit pass-1
  values for the first scoring pass, the requant to int8 where the top
  probability over every head falls below the threshold);
- each query head keeps its own importance row (the head mask ranks query
  heads); token pruning sums the rows over the heads, keeps the start,
  the layer's budget of most important and the recent tokens, moves them
  to the front, re-rotates only a moved row's rope lanes by its slot
  delta and requantizes the whole row (the value plane's copy of the row
  moves unchanged, as the program's V plane does);
- V pruning keeps each query head's top value blocks by probability mass;
  masked heads are zeroed; the serving head mask comes from the program's
  run, as in ``spatten_ref.py``.

It fits beside the program on one card: the weights stay in the tree's
bfloat16 and each matrix is upcast to float32 where it is used (an expert
layer's experts once per call), never the whole tree at once.  Precision
"fp8" rounds each matrix to float8 e4m3 (one scale per output channel) at
that use, and each product's input per row.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.spatten_ref import (
    _bf16, fp8_round, head_mask_from_importance, msb_values, quant_rows,
    rms_norm,
)

__all__ = ["Knobs", "Reference", "judge", "head_mask_from_importance",
           "prune_layer", "yarn_inv_freq", "softmax_scale"]

F32 = torch.float32
NEG_INF = float("-inf")


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float, device) -> torch.Tensor:
    """The published ``DeepseekV2YarnRotaryEmbedding`` frequencies [dim/2]."""
    def corr(rot):
        return (dim * math.log(original / (rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(dim // 2, dtype=F32, device=device)
    ramp = torch.clamp((i - low) / (high - low), 0, 1)
    expo = torch.arange(0, dim, 2, dtype=F32, device=device) / dim
    extra = 1.0 / base ** expo
    inter = 1.0 / (factor * base ** expo)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(c: dict) -> float:
    """``(qk_nope + qk_rope) ** -0.5`` times YaRN's mscale(factor,
    mscale_all_dim) squared (the published attention's softmax scale)."""
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    rs = c.get("rope_scaling") or {}
    if rs.get("mscale_all_dim"):
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale *= m * m
    return scale


@dataclass(frozen=True)
class Knobs:
    """The model's sizes and SpAtten's settings, from the config file.

    ``kv_heads`` is the number of head groups the head mask ranks: every
    query head (the latent row is one cached head, read by all of them),
    so ``group`` is 1; ``head_dim`` is the cached row's lanes (``rank +
    rope``).  The cache as a yardstick counts it (``counts.k1_bytes``'s
    ``kv_heads`` and ``group``) is ``cache_heads`` rows a token, each
    read by ``cache_group`` query heads."""

    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    rank: int
    nope: int
    rope: int
    v_dim: int
    eps: float
    theta: float
    yarn: tuple              # factor, original, beta_fast, beta_slow, mscale
    scale: float
    cap: int
    chunk: int
    start: int
    recent: int
    budgets: tuple
    rungs: tuple
    v_keep: tuple
    v_block: int
    requant: float
    quant: bool              # False: the first pass reads the int8 rows
    ema: float
    imp_bf16: bool
    scale_bf16: bool
    top_k: int
    first_dense: int
    norm_topk: bool
    routed_scale: float

    @property
    def group(self) -> int:
        return self.heads // self.kv_heads

    @property
    def cache_heads(self) -> int:
        return 1

    @property
    def cache_group(self) -> int:
        return self.heads

    @staticmethod
    def from_config(c: dict) -> "Knobs":
        s, e = c["spatten"], c["engine"]
        layers = c["num_hidden_layers"]
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
        rs = c.get("rope_scaling") or {}
        yarn = (float(rs.get("factor", 1.0)),
                int(rs.get("original_max_position_embeddings", 4096)),
                float(rs.get("beta_fast", 32)), float(rs.get("beta_slow", 1)),
                float(rs.get("mscale", 1.0)),
                float(rs.get("mscale_all_dim", 0.0)))
        heads = c["num_attention_heads"]
        return Knobs(
            layers=layers, heads=heads, kv_heads=heads,
            head_dim=c["kv_lora_rank"] + c["qk_rope_head_dim"],
            rank=c["kv_lora_rank"], nope=c["qk_nope_head_dim"],
            rope=c["qk_rope_head_dim"], v_dim=c["v_head_dim"],
            eps=c["rms_norm_eps"], theta=float(c["rope_theta"]), yarn=yarn,
            scale=softmax_scale(c), cap=cap, chunk=e["prefill_chunk"],
            start=s["start_size"], recent=s["recent_size"], budgets=budgets,
            rungs=rungs, v_keep=v_keep, v_block=vb,
            requant=(s["requant_threshold"] if s["quant_enabled"]
                     and s["enable_requant"] else 0.0),
            quant=bool(s["quant_enabled"]), ema=s["importance_ema"],
            imp_bf16=s["importance_dtype"] == "bfloat16",
            scale_bf16=s["scale_dtype"] == "bfloat16",
            top_k=c["num_experts_per_tok"],
            first_dense=c["first_k_dense_replace"],
            norm_topk=bool(c["norm_topk_prob"]),
            routed_scale=float(c["routed_scaling_factor"]))

    def keep_blocks(self, l: int) -> int:
        """Layer ``l``'s kept V blocks, or 0 for no V pruning (as in
        ``spatten_ref.Knobs.keep_blocks``)."""
        nvb = self.rungs[l] // self.v_block
        if not any(0 < x and max(1, -(-x // self.v_block)) < nvb
                   for x in self.v_keep):
            return 0
        return max(1, -(-self.v_keep[l] // self.v_block))

    def inv_freq(self, device) -> torch.Tensor:
        factor, orig, fast, slow, _, _ = self.yarn
        if factor > 1.0:
            return yarn_inv_freq(self.rope, self.theta, factor, orig, fast,
                                 slow, device)
        return 1.0 / self.theta ** (torch.arange(
            0, self.rope, 2, dtype=F32, device=device) / self.rope)

    def mscale(self) -> float:
        factor, _, _, _, ms, ms_all = self.yarn
        if factor <= 1.0:
            return 1.0
        return yarn_mscale(factor, ms) / yarn_mscale(factor, ms_all)


def deinterleave(x: torch.Tensor) -> torch.Tensor:
    """The published ``apply_rotary_pos_emb``'s reordering of the rope
    lanes: even lanes first, then odd ones."""
    return torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)


def rotate(x: torch.Tensor, pos: torch.Tensor, inv_freq: torch.Tensor,
           mscale: float = 1.0) -> torch.Tensor:
    """Rotate-half x [..., r] by the angle ``pos * inv_freq`` (cos and sin
    times ``mscale``, as the published table carries them)."""
    ang = pos.to(F32)[..., None] * inv_freq
    ang = torch.cat([ang, ang], dim=-1)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * (torch.cos(ang) * mscale) + rot * (torch.sin(ang) * mscale)


class Cache:
    """The reference's latent cache of ``rows`` sequences, [L][rows, C,
    R + rope]: the K rows' int8 values with their stored scales, their
    dequantized values (full and 4-bit), the V rows dequantized, one
    importance row per query head [rows, Hq, C] and each layer's live
    length."""

    def __init__(self, k: Knobs, rows: int, device):
        L, C, W, H = k.layers, k.cap, k.head_dim, k.heads
        z = lambda *s: torch.zeros(s, dtype=F32, device=device)  # noqa: E731
        self.kq = [torch.zeros((rows, C, W), dtype=torch.int8,
                               device=device) for _ in range(L)]
        self.ksc = [torch.ones(rows, C, device=device) for _ in range(L)]
        self.kfull = [z(rows, C, W) for _ in range(L)]
        self.kmsb = [z(rows, C, W) for _ in range(L)]
        self.vfull = [z(rows, C, W) for _ in range(L)]
        self.imp = [z(rows, H, C) for _ in range(L)]
        self.lens = np.zeros((L, rows), dtype=np.int64)
        self.lens_dev = torch.zeros((L, rows), dtype=torch.int64,
                                    device=device)

    def clear(self) -> "Cache":
        for imp in self.imp:
            imp.zero_()
        self.lens[:] = 0
        self.lens_dev.zero_()
        return self

    def copy_row(self, row: int, src: "Cache", src_row: int) -> None:
        for name in ("kq", "ksc", "kfull", "kmsb", "vfull", "imp"):
            for dst, got in zip(getattr(self, name), getattr(src, name)):
                dst[row] = got[src_row]
        self.lens[:, row] = src.lens[:, src_row]
        self.lens_dev[:, row] = src.lens_dev[:, src_row]

    def write(self, l: int, rows: torch.Tensor, slots: torch.Tensor,
              x: torch.Tensor, scale_bf16: bool) -> None:
        """Quantize latent rows x [n, W] into (rows[i], slots[i]), in the
        K and the V plane alike."""
        q, sc = quant_rows(x, scale_bf16)
        self.kq[l][rows, slots] = q.to(torch.int8)
        self.ksc[l][rows, slots] = sc
        self.kfull[l][rows, slots] = q * sc[..., None]
        self.kmsb[l][rows, slots] = msb_values(q) * sc[..., None]
        self.vfull[l][rows, slots] = q * sc[..., None]


def prune_layer(k: Knobs, cache: Cache, l: int, rows: list[int],
                inv_freq: torch.Tensor) -> None:
    """Cascade prune of layer ``l`` for sequences ``rows``: the importance
    rows summed over the query heads rank the middle tokens; keep the
    first ``start``, the layer's budget most important (ties to the lower
    slot) and the last ``recent``, moved to the front in order; a moved
    K row's rope lanes re-rotate by its slot delta (the latent lanes keep
    their values) and the whole row requantizes; the V row moves as it
    is.  Each importance row follows its token; the slots from the keep
    count up to the static keep bound take the dropped tokens' importance
    in slot order (``spatten_ref.prune_layer``)."""
    budget = k.budgets[l]
    keep_max = k.start + budget + k.recent
    win = k.rungs[l]
    dev = cache.imp[l].device
    r0 = k.rank
    for b in rows:
        n = int(cache.lens[l, b])
        rb = n - k.recent
        n_imp = min(budget, max(rb - k.start, 0))
        count = k.start + n_imp + k.recent
        imp = cache.imp[l][b]                                   # [H, C]
        score = imp.sum(dim=0)                                  # [C]
        pos = torch.arange(win, device=dev)
        middle = (pos >= k.start) & (pos < rb)
        masked = torch.where(middle, score[:win], NEG_INF)
        top = torch.sort(masked, descending=True, stable=True).indices[:n_imp]
        kept = torch.cat([torch.arange(k.start, device=dev),
                          torch.sort(top).values,
                          rb + torch.arange(k.recent, device=dev)])
        delta = torch.arange(count, device=dev) - kept          # <= 0
        kq = cache.kq[l][b][kept].to(F32)                       # [n, W]
        ks = cache.ksc[l][b][kept]
        x = kq * ks[..., None]
        xr = torch.cat([x[:, :r0], rotate(x[:, r0:], delta.to(F32),
                                          inv_freq)], dim=-1)
        q2, s2 = quant_rows(xr, k.scale_bf16)
        moved = delta < 0
        kq = torch.where(moved[:, None], q2, kq)
        ks = torch.where(moved, s2, ks)
        cache.kq[l][b, :count] = kq.to(torch.int8)
        cache.ksc[l][b, :count] = ks
        cache.kfull[l][b, :count] = kq * ks[..., None]
        cache.kmsb[l][b, :count] = msb_values(kq) * ks[..., None]
        cache.vfull[l][b, :count] = cache.vfull[l][b][kept]
        keepm = torch.zeros(win, dtype=torch.bool, device=dev)
        keepm[kept] = True
        order = torch.argsort(torch.where(keepm, pos, win + pos))
        upto = min(keep_max, win)
        cache.imp[l][b, :, :upto] = imp[:, :win][:, order][:, :upto]
        cache.lens[l, b] = count
        cache.lens_dev[l, b] = count


class Reference:
    """The reference decoder over the tree's weights, each upcast to
    float32 where used (``precision`` "fp8": rounded to float8 e4m3 at that
    use, one scale per output channel, and each product's input per
    row)."""

    def __init__(self, knobs: Knobs, params: dict, device,
                 precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision {precision!r}")
        self.k = knobs
        self.dev = torch.device(device)
        self.fp8 = precision == "fp8"
        self.lay = params["layers"]
        self.embed = params["embed"]
        self.final_norm = params["final_norm_w"].to(self.dev, F32)
        self.lm_head = self.w(params["lm_head"], in_axis=-2)
        self.inv_freq = knobs.inv_freq(self.dev)
        self.mscale = knobs.mscale()

    def w(self, t: torch.Tensor, in_axis: int) -> torch.Tensor:
        """A weight in float32 (rounded to e4m3 per output channel, over
        ``in_axis``, under "fp8")."""
        t = t.to(self.dev, F32)
        return fp8_round(t, dim=in_axis) if self.fp8 else t

    def x_in(self, x: torch.Tensor) -> torch.Tensor:
        return fp8_round(x, dim=-1) if self.fp8 else x

    def mm(self, x: torch.Tensor, name: str, l: int) -> torch.Tensor:
        """x @ layers[name][l] (an [in, out] matrix)."""
        return self.x_in(x) @ self.w(self.lay[name][l], in_axis=-2)

    # -- one layer's pieces ------------------------------------------------
    def _proj(self, l: int, x: torch.Tensor, pos: torch.Tensor):
        """x [n, S, hidden]; pos [n, S] -> (q_nope [n, S, H, nope], rotated
        q_pe [n, S, H, rope], the latent rows [n, S, R + rope])."""
        k = self.k
        n, s, _ = x.shape
        h = rms_norm(x, self.lay["attn_norm_w"][l].to(self.dev, F32), k.eps)
        q = self.mm(h, "wq", l).reshape(n, s, k.heads, k.nope + k.rope)
        kv = self.mm(h, "wkv_a", l)
        c = rms_norm(kv[..., :k.rank],
                     self.lay["kv_a_norm_w"][l].to(self.dev, F32), k.eps)
        q_pe = rotate(deinterleave(q[..., k.nope:]), pos[:, :, None],
                      self.inv_freq, self.mscale)
        k_pe = rotate(deinterleave(kv[..., k.rank:]), pos, self.inv_freq,
                      self.mscale)
        return q[..., :k.nope], q_pe, torch.cat([c, k_pe], dim=-1)

    def _heads(self, l: int, lat: torch.Tensor):
        """Per-head keys' nope lanes and values from latent rows [n, C,
        W]: (k_nope [n, H, C, nope], v [n, H, C, v])."""
        k = self.k
        w_uk = self.w(self.lay["w_uk"][l], in_axis=-1)          # [H, nope, R]
        w_uv = self.w(self.lay["w_uv"][l], in_axis=-2)          # [H, R, v]
        c = self.x_in(lat[..., :k.rank])
        return (torch.einsum("bcr,hnr->bhcn", c, w_uk),
                torch.einsum("bcr,hrv->bhcv", c, w_uv))

    def _out(self, l: int, x: torch.Tensor, out: torch.Tensor):
        """out [n, H, S, v] -> the residual after W_o and the MLP."""
        n, _, s, _ = out.shape
        x = x + self.mm(out.transpose(1, 2).reshape(n, s, -1), "wo", l)
        h = rms_norm(x, self.lay["mlp_norm_w"][l].to(self.dev, F32),
                     self.k.eps)
        return x + self._mlp(l, h)

    def _swiglu(self, h, wg, wu, wd):
        act = torch.nn.functional.silu(self.x_in(h) @ wg)
        return self.x_in(act * (self.x_in(h) @ wu)) @ wd

    def _mlp(self, l: int, h: torch.Tensor) -> torch.Tensor:
        """Dense SwiGLU in the leading layers; else the routed experts
        (softmax router in f32, greedy top-k, each picked expert's SwiGLU
        weighted by its probability) plus the shared experts."""
        k = self.k
        if l < k.first_dense:
            d = self.lay["dense"]
            return self._swiglu(h, self.w(d["w_gate"][l], -2),
                                self.w(d["w_up"][l], -2),
                                self.w(d["w_down"][l], -2))
        mp = self.lay["moe"]
        j = l - k.first_dense
        shape = h.shape
        hf = h.reshape(-1, shape[-1])
        scores = torch.softmax(self.x_in(hf) @ self.w(mp["router"][j], -2),
                               dim=-1)
        wts, idx = torch.topk(scores, k.top_k, dim=-1)
        if k.norm_topk:
            wts = wts / wts.sum(-1, keepdim=True)
        wts = wts * k.routed_scale
        gate_up = self.w(mp["w_gate_up"][j], in_axis=-1)        # [E, 2I, D]
        down = self.w(mp["w_down"][j], in_axis=-1)              # [E, D, I]
        inter = down.shape[-1]
        y = torch.zeros_like(hf)
        for e in torch.unique(idx).tolist():
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            ye = self._swiglu(hf[tok], gate_up[e, :inter].T,
                              gate_up[e, inter:].T, down[e].T)
            y.index_add_(0, tok, ye * wts[tok, slot][:, None])
        del gate_up, down
        y = y + self._swiglu(hf, self.w(mp["shared_gate"][j], -2),
                             self.w(mp["shared_up"][j], -2),
                             self.w(mp["shared_down"][j], -2))
        return y.reshape(shape)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.x_in(rms_norm(x, self.final_norm, self.k.eps)) \
            @ self.lm_head

    # -- prefill ---------------------------------------------------------
    def prefill_chunk(self, cache: Cache, row: int, ids: torch.Tensor
                      ) -> torch.Tensor:
        """One prompt chunk ids [S] of sequence ``row``, pruning first any
        layer the chunk would overflow: full-precision scores over the
        int8 latent rows, no V pruning, every query's probabilities added
        to its head's importance row.  Returns the last logits [vocab]."""
        k = self.k
        s = ids.shape[0]
        for l in range(k.layers):
            if int(cache.lens[l, row]) + s > k.rungs[l]:
                prune_layer(k, cache, l, [row], self.inv_freq)
        x = self.embed[ids].to(self.dev, F32)[None]
        ar = torch.arange(s, device=self.dev)
        rows = torch.full((s,), row, device=self.dev)
        cols = torch.arange(k.cap, device=self.dev)
        for l in range(k.layers):
            n0 = int(cache.lens[l, row])
            pos = torch.clamp(n0 + ar, max=k.cap - 1)
            q_nope, q_pe, lat = self._proj(l, x, pos[None])
            cache.write(l, rows, n0 + ar, lat[0], k.scale_bf16)
            n = n0 + s
            keys = cache.kfull[l][row:row + 1, :n]              # [1, n, W]
            k_nope, _ = self._heads(l, keys)
            _, v = self._heads(l, cache.vfull[l][row:row + 1, :n])
            sc = (torch.einsum("shn,hcn->hsc", q_nope[0], k_nope[0])
                  + torch.einsum("shr,cr->hsc", q_pe[0],
                                 keys[0, :, k.rank:])) * k.scale
            causal = torch.arange(n, device=self.dev)[None] <= pos[:, None]
            p = torch.softmax(torch.where(causal, sc, NEG_INF), dim=-1)
            new = (cols >= n0) & (cols < n)
            acc = torch.where(new, 0.0, cache.imp[l][row]) * k.ema
            acc[:, :n] += p.sum(dim=1)
            cache.imp[l][row] = _bf16(acc) if k.imp_bf16 else acc
            out = torch.einsum("hsc,hcv->hsv", p, v[0])[None]
            cache.lens[l, row] = n
            cache.lens_dev[l, row] = n
            x = self._out(l, x, out)
        return self.logits(x[0, -1])

    def prefill(self, cache: Cache, prompt) -> torch.Tensor:
        """A whole prompt into the one-row ``cache``, in chunks as the
        engine takes them (a chunk of one token is a decode step, every
        head live)."""
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
        """One decode step of every row (tokens [n]; head_mask [n, L, Hq]),
        as the K1 kernel's contract states it for the latent row: append
        the token's quantized row; pass-1 scores on the 4-bit rows; the
        requant to the int8 rows where every head's top probability
        (before head masking) is below the threshold; masked heads
        zeroed; each live head's importance row on the live columns set
        to imp + its probabilities (the new slot from 0), a masked head's
        left as it is; P.V over each head's kept V blocks, not
        renormalised.  Returns logits [n, vocab]."""
        k = self.k
        nrows = tokens.shape[0]
        dev = self.dev
        for l in range(k.layers):
            due = [b for b in range(nrows)
                   if int(cache.lens[l, b]) + 1 > k.rungs[l]]
            if due:
                prune_layer(k, cache, l, due, self.inv_freq)
        x = self.embed[tokens].to(dev, F32)[:, None]
        ri = torch.arange(nrows, device=dev)
        cols = torch.arange(k.cap, device=dev)
        for l in range(k.layers):
            n0 = cache.lens_dev[l].clone()
            pos = torch.clamp(n0, max=k.cap - 1)
            q_nope, q_pe, lat = self._proj(l, x, pos[:, None])
            cache.write(l, ri, n0, lat[:, 0], k.scale_bf16)
            n = n0 + 1
            live = cols[None] < n[:, None]                      # [n, C]
            qn, qp = q_nope[:, 0], q_pe[:, 0]                   # [n, H, .]

            def probs(rows):
                k_nope, _ = self._heads(l, rows)
                sc = (torch.einsum("bhn,bhcn->bhc", qn, k_nope)
                      + torch.einsum("bhr,bcr->bhc", qp,
                                     rows[..., k.rank:])) * k.scale
                return torch.softmax(
                    torch.where(live[:, None], sc, NEG_INF), dim=-1)

            p = probs(cache.kmsb[l] if k.quant else cache.kfull[l])
            hm = head_mask[:, l]                                # [n, H]
            alive = hm.any(-1)                                  # [n]
            if k.requant > 0:
                need = alive & (p.amax(dim=(-1, -2)) < k.requant)
                if bool(need.any()):
                    p = torch.where(need[:, None, None],
                                    probs(cache.kfull[l]), p)
            p = p * hm[..., None]
            at = cols[None] == n0[:, None]
            imp = cache.imp[l]
            upd = live[:, None] & hm[..., None]
            new = torch.where(at[:, None], 0.0, imp) * k.ema + p
            new = _bf16(new) if k.imp_bf16 else new
            cache.imp[l] = torch.where(upd, new, imp)
            kb = k.keep_blocks(l)
            if kb:
                nb = k.cap // k.v_block
                mass = p.reshape(nrows, k.heads, nb, k.v_block).sum(-1)
                if kb < nb:
                    kth = torch.sort(mass, dim=-1, descending=True
                                     ).values[..., kb - 1:kb]
                    keep = (mass >= kth) & (mass > 0)
                    p = p * keep.repeat_interleave(k.v_block, dim=-1)
            _, v = self._heads(l, cache.vfull[l])
            out = torch.einsum("bhc,bhcv->bhv", p, v)
            del v
            cache.lens[l] += 1
            cache.lens_dev[l] += 1
            x = self._out(l, x, out[:, :, None])
        return self.logits(x[:, 0])


def judge(ref: Reference, rows: list[dict], mask_table: torch.Tensor,
          logits_out: list | None = None, batch: int = 8
          ) -> list[torch.Tensor]:
    """``spatten_ref.judge`` over this reference: per row, the gap by
    which each judged token's reference logit lies below the reference's
    best (f32 [n_judged]); ``logits_out`` receives the logits."""
    out: list[torch.Tensor] = []
    for b0 in range(0, len(rows), batch):
        part = rows[b0:b0 + batch]
        kept: list = [] if logits_out is not None else None
        out += _judge_batch(ref, part, mask_table, kept)
        if kept is not None:
            logits_out.extend(kept)
    return out


def _judge_batch(ref: Reference, rows: list[dict], mask_table, logits_out):
    k, dev = ref.k, ref.dev
    if any("start" in r for r in rows):
        raise NotImplementedError("deepseek_v2_ref judges requests from "
                                  "their prompts, not sessions' caches")
    cache = Cache(k, len(rows), dev)
    gaps: list[list[torch.Tensor]] = [[] for _ in rows]
    kept: list[list[torch.Tensor]] = [[] for _ in rows]
    one = None
    for b, r in enumerate(rows):
        one = Cache(k, 1, dev) if one is None else one.clear()
        lg = ref.prefill(one, r["prompt"])
        cache.copy_row(b, one, 0)
        gaps[b].append(lg.max() - lg[int(r["tokens"][0])])
        if logits_out is not None:
            kept[b].append(lg.cpu())
    del one
    steps = max(len(r["tokens"]) for r in rows) - 1
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
