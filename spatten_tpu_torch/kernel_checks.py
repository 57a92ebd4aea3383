"""The rules by which a kernel's result is held against its plain version
on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

Both sides run on the same inputs, so integer results must be equal and
float results may differ only by summation order -- except where a
decision sits on a boundary: a requant threshold, a V-block k-th/(k+1)-th
mass tie, or an 8-bit P·V weight or bf16 probability whose rounding a
last-bit difference flips.  Decisions within ``DECISION_MARGIN`` may go
either way and their rows are excluded; a flipped rounding moves a row's
output by at most one step of one token, which the per-row tolerance
allows twice.

A whole ``generate`` run on the card is held against the CPU call by
call (``check_against_cpu``): each prefill chunk and decode step is
replayed on the CPU from a copy of the card's state just before it.  f32
logits agree within ``CPU_REPLAY_LOGIT_TOL`` (the card sums in another
order) and greedy tokens wherever the CPU's top two logits lie more than
``TOP2_MARGIN`` apart.  Two free runs would drift further apart: the
projections' last-bit differences flip int8 roundings at half a step, a
flip across a multiple of 16 moves a 4-bit pass-1 nibble by a whole
step, and the cascade's importance, keep sets and logits follow.
"""

from __future__ import annotations

from typing import Optional

import torch

DECISION_MARGIN = 1e-5          # closer decisions may flip either way
K1_OUT_TOL = dict(atol=1e-4, rtol=1e-4)      # f32 sums in another order
K1_MAXP_TOL = dict(atol=1e-6, rtol=1e-4)
K1_IMP_TOL = dict(atol=1e-5, rtol=1e-4)
K1_IMP_BF16_TOL = dict(atol=1e-5, rtol=2 ** -7)   # one bf16 step
# presoftmax importance sums scaled scores: 1e-4 of the row's largest
# |score| (the scores themselves carry f32 rounding of that size)
K1_PRESOFTMAX_REL = 1e-4
K1_ROW_STATS_TOL = dict(atol=1e-6, rtol=1e-5)     # m and den per row
CPU_REPLAY_LOGIT_TOL = 1e-3     # f32 logits, card vs CPU, same call
TOP2_MARGIN = 1e-3              # closer top-2 logits may pick either token


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def _presoftmax_close(got, want, base=None) -> bool:
    """Presoftmax importance [..., n]: within K1_PRESOFTMAX_REL of each
    row's largest |delta| (``base``: the accumulator before the call, so
    that the delta is want - base), plus the f32 floor."""
    if want.shape[-1] == 0:
        return True
    delta = want if base is None else want - base
    scale = delta.abs().amax(-1, keepdim=True)
    tol = K1_IMP_TOL["atol"] + K1_PRESOFTMAX_REL * scale \
        + K1_IMP_TOL["rtol"] * want.abs()
    return bool(((got - want).abs() <= tol).all())


def check_k1(kernel, plain, *, layer: int, lengths, threshold: float,
             keep_blocks: int, v_block: int, keep_out: Optional[torch.Tensor],
             head_mask: Optional[torch.Tensor] = None,
             importance_before: Optional[torch.Tensor] = None,
             rounded_weights: bool = False, presoftmax: bool = False,
             delta: Optional[tuple] = None, row_stats: Optional[tuple] = None,
             append_mask: Optional[torch.Tensor] = None,
             planes_before=None) -> dict:
    """Hold one K1 call against its plain version.

    ``kernel`` / ``plain``: (out, stats, state) after the call, where
    ``state`` is the DecodeState whose stacked planes and importance the
    call updated; ``stats.probs`` of the plain side carries its
    head-masked normalized probabilities.  ``keep_out``: the kernel's
    per-row V-block keep mask (uint8 [B, Hq, nvb]).  ``rounded_weights``:
    pv_int8 or probs_bf16 was on, so one token's weight may sit one
    8-bit (or bf16) step apart.  ``importance_before``: the layer's
    accumulator before the call, for the dead-group check.  Raises
    AssertionError on a mismatch; returns counts for the log.

    The remaining flags: ``presoftmax`` (importance sums scores: held to
    K1_PRESOFTMAX_REL of each row's largest |score|); ``delta``: (kernel,
    plain) delta-mode importance [B, Hkv or Hq, rung] -- zero past each
    row's length in the kernel, exact; ``row_stats``: ((m, den) kernel,
    (m, den) plain) [B, Hq]; ``append_mask`` with ``planes_before`` (the
    state before the call): rows that do not append keep every plane and
    scale byte."""
    out_k, st_k, s_k = kernel
    out_p, st_p, s_p = plain
    b, hq = out_k.shape[:2]
    hkv = st_k.max_prob.shape[1]
    group = hq // hkv
    # planes after the append: exact, every layer
    for a, c in ((s_k.cache.k, s_p.cache.k), (s_k.cache.v, s_p.cache.v)):
        for name in ("full", "msb", "lsb2", "scale"):
            x, y = getattr(a, name), getattr(c, name)
            if x is not None:
                check(torch.equal(x, y), f"K1 {name} plane differs from the "
                      "plain version")
    if append_mask is not None:
        still = ~append_mask.to(torch.bool)
        for a, c in ((s_k.cache.k, planes_before.cache.k),
                     (s_k.cache.v, planes_before.cache.v)):
            for name in ("full", "msb", "lsb2", "scale"):
                x, y = getattr(a, name), getattr(c, name)
                if x is not None:
                    check(torch.equal(x[:, still], y[:, still]),
                          f"K1 wrote the {name} plane of a row that does "
                          "not append")
    # requant decisions: exact unless the max prob is within the margin
    near_t = (st_p.max_prob - threshold).abs() < DECISION_MARGIN
    if threshold <= 0:
        near_t = torch.zeros_like(near_t)
    flips = st_k.need_requant != st_p.need_requant
    check(not bool((flips & ~near_t).any()), "K1 need_requant differs")
    probs = st_p.probs[:, :, 0].to(torch.float32)       # [B, Hq, rung]
    rung = probs.shape[-1]
    row_near = near_t.repeat_interleave(group, dim=1)
    if keep_blocks:
        nvb = rung // v_block
        mass = probs.reshape(b, hq, nvb, v_block).sum(-1)
        srt = torch.sort(mass, dim=-1, descending=True).values
        kb = min(keep_blocks, nvb)
        kth = srt[..., kb - 1:kb]
        nxt = srt[..., kb:kb + 1] if kb < nvb else torch.zeros_like(kth)
        keep_p = (mass >= kth) & (mass > 0)
        margin = torch.where(keep_p, mass - nxt, kth - mass)
        # a row is ambiguous when its k-th and (k+1)-th block masses
        # nearly tie (with fewer live blocks than k, kth == 0)
        row_near = row_near | (((kth - nxt)[..., 0] < DECISION_MARGIN)
                               & (kth[..., 0] > 0))
        bad = (keep_out.bool() != keep_p) & (margin >= DECISION_MARGIN) \
            & ~row_near[..., None]
        check(not bool(bad.any()), f"K1 keeps {int(bad.sum())} V blocks "
              "differently from the plain version")
    ok = ~row_near
    err = (out_k - out_p).abs()[:, :, 0].amax(-1)         # [B, Hq]
    if rounded_weights:
        # one token's weight one step apart moves the row by at most
        # wmax = max(p * vscale): an 8-bit step is wmax / 127 times
        # |v8| <= 127, a bf16 step 2^-8 of the weight times |v8|
        vsc = s_p.cache.v.scale[layer, ..., :rung].to(torch.float32)
        wmax = (probs * vsc.repeat_interleave(group, dim=1)).amax(-1)
        tol = K1_OUT_TOL["atol"] + 2 * wmax
        check(bool((err <= tol)[ok].all()), "K1 out differs beyond two "
              f"weight steps (max err {float(err[ok].max()):.3e})")
    else:
        check(bool(torch.allclose(out_k[ok], out_p[ok], **K1_OUT_TOL)),
              f"K1 out differs (max err {float(err[ok].max()):.3e})")
    check(bool(torch.allclose(st_k.max_prob, st_p.max_prob, **K1_MAXP_TOL)),
          "K1 max_prob differs")
    if row_stats is not None:
        (m_k, d_k), (m_p, d_p) = row_stats
        for x, y, what in ((m_k, m_p, "m"), (d_k, d_p, "den")):
            if not torch.allclose(x[ok], y[ok], **K1_ROW_STATS_TOL):
                raise AssertionError(f"K1 row stat {what} differs (max err "
                                     f"{float((x - y)[ok].abs().max()):.3e})")
    if delta is not None:
        dk, dp = delta
        check(dk.shape == dp.shape, f"K1 delta shape {tuple(dk.shape)}")
        rows_near = near_t if dk.shape[1] == hkv else row_near
        for bi, n in enumerate(lengths):
            keep_rows = ~rows_near[bi]
            check(not bool(dk[bi, :, n:].any()), "K1 delta is not zero past "
                  "the length")
            x, y = dk[bi, keep_rows, :n], dp[bi, keep_rows, :n]
            close = (_presoftmax_close(x, y) if presoftmax
                     else bool(torch.allclose(x, y, **K1_IMP_TOL)))
            if not close:
                raise AssertionError("K1 importance delta differs (max err "
                                     f"{float((x - y).abs().max()):.3e})")
    imp_k, imp_p = s_k.importance[layer], s_p.importance[layer]
    tol = K1_IMP_BF16_TOL if imp_k.dtype == torch.bfloat16 else K1_IMP_TOL
    live = torch.zeros(s_k.importance.shape, dtype=torch.bool,
                       device=s_k.importance.device)
    # a latent cache's accumulator holds a row per query head
    imp_near = near_t if imp_k.shape[1] == hkv else row_near
    for bi, n in enumerate(lengths):
        heads = ~imp_near[bi]
        x, y = imp_k[bi, heads, :n].float(), imp_p[bi, heads, :n].float()
        if presoftmax and importance_before is not None \
                and imp_k.dtype == torch.float32:
            close = _presoftmax_close(
                x, y, importance_before[bi, heads, :n].float())
        else:
            close = bool(torch.allclose(x, y, **tol))
        check(close, "K1 importance differs")
        live[layer, bi, :, :n] = True
    # everywhere else the accumulator keeps its bytes: the other layers,
    # and the columns at or past a row's length, which the head mask
    # update still reads
    check(torch.equal(s_k.importance[~live], s_p.importance[~live]),
          "K1 changed importance outside the call's live columns")
    dead_groups = 0
    if head_mask is not None:
        hm = (head_mask if head_mask.ndim == 2 else head_mask[None]
              ).expand(b, hq)
        dead = ~hm.reshape(b, hkv, group).any(-1)          # [B, Hkv]
        dead_groups = int(dead.sum())
        dead_rows = dead.repeat_interleave(group, dim=1)
        check(bool((out_k[:, :, 0][~hm] == 0).all()),
              "K1 dead head rows are not zero")
        check(bool((st_k.max_prob[dead] == 0).all()),
              "K1 dead groups report a max prob")
        if importance_before is not None:
            gone = dead if imp_k.shape[1] == hkv else dead_rows
            check(torch.equal(imp_k[gone], importance_before[gone]),
                  "K1 touched a dead group's importance")
        check(bool((out_p[:, :, 0][dead_rows] == 0).all()),
              "plain dead head rows are not zero")
    return dict(max_abs_err=float(err[ok].max()), fired=int(
        st_k.need_requant.sum()), near_threshold=int(near_t.sum()),
        near_rows=int(row_near.sum()), dead_groups=dead_groups,
        out_exact=int((out_k == out_p).sum()), out_total=out_k.numel())


def random_state(cfg, batch: int, generator: torch.Generator,
                 device: torch.device):
    """A decode state of ``cfg`` whose every layer holds the same cache of
    quantized standard normals (the planes the config carries, in its
    scale dtype) and a uniform importance accumulator."""
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.ops import quantize as qz
    m, cap = cfg.model, cfg.engine.cache_capacity
    st = init_state(cfg, batch=batch, device=device)
    shape = (batch, m.cache_heads, cap, m.cache_dim)
    for dst, msb in ((st.cache.k, True), (st.cache.v, False)):
        src = qz.quantize(torch.randn(shape, generator=generator,
                                      device=device), with_msb=msb,
                          with_lsb2=msb and dst.lsb2 is not None)
        for name in ("full", "msb", "scale", "lsb2"):
            if getattr(dst, name) is not None:
                getattr(dst, name).copy_(getattr(src, name)[None])
    st.importance.copy_(torch.rand(st.importance.shape, generator=generator,
                                   device=device))
    return st


def k1_pair(state, q, k_new, v_new, lengths, *, layer: int, threshold: float,
            v_block: int, keep_blocks_for, head_mask=None,
            delta_mode: bool = False, **flags) -> dict:
    """Run K1 and its plain version from two clones of ``state`` on the
    same inputs and hold them against each other (``check_k1``).
    ``keep_blocks_for(rung)``: the layer's V keep-block count in the
    call's window (0 = V pruning off).  ``delta_mode``: importance as this
    step's delta (no accumulator); ``flags`` may hold the split-K flags
    (``append_mask``, ``return_row_stats``, ``per_row_importance``)."""
    from spatten_tpu_torch.ops import fused_decode as fd
    a, c = state.clone(), state.clone()
    b, hq = q.shape[:2]
    rung = flags.get("cap_override") or state.capacity
    nvb = rung // v_block
    keep = torch.zeros((b, hq, nvb), dtype=torch.uint8, device=q.device)
    kw = dict(requant_threshold=threshold, layer=layer, v_block_size=v_block,
              head_mask=head_mask, **flags)
    imp_before = state.importance[layer].clone()
    before = fd.fused_decode_attention.launches
    res_k = fd.fused_decode_attention(
        q, a.cache.k, a.cache.v, k_new, v_new, lengths,
        importance_in=None if delta_mode else a.importance, keep_out=keep,
        **kw)
    res_p = fd.fused_decode_attention_plain(
        q, c.cache.k, c.cache.v, k_new, v_new, lengths,
        importance_in=None if delta_mode else c.importance, **kw)
    torch.cuda.synchronize()
    check(fd.fused_decode_attention.launches == before + 1,
          "K1 did not count its launch")
    (out_k, st_k), (out_p, st_p) = res_k[:2], res_p[:2]
    am = flags.get("append_mask")
    return check_k1((out_k, st_k, a), (out_p, st_p, c), layer=layer,
                    lengths=lengths.tolist(), threshold=threshold,
                    keep_blocks=keep_blocks_for(rung), v_block=v_block,
                    keep_out=keep, head_mask=head_mask,
                    importance_before=imp_before,
                    rounded_weights=bool(flags.get("pv_int8")
                                         or flags.get("probs_bf16")),
                    presoftmax=flags.get("importance_kind") == "presoftmax",
                    delta=((st_k.importance_delta, st_p.importance_delta)
                           if delta_mode else None),
                    row_stats=((res_k[4], res_p[4])
                               if flags.get("return_row_stats") else None),
                    append_mask=None if am is None else torch.as_tensor(am),
                    planes_before=state if am is not None else None)


def _ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """f32 values as int64 keys that order as the values do, one apart
    per representable step (units in the last place)."""
    i = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def _agreement(got: torch.Tensor, want: torch.Tensor,
               where: Optional[torch.Tensor] = None) -> dict:
    """How many elements of ``got`` equal ``want`` bit for bit (within
    ``where``), the largest distance in f32 ulps and the largest |diff|."""
    if where is None:
        where = torch.ones_like(got, dtype=torch.bool)
    g, w = got[where].to(torch.float32), want[where].to(torch.float32)
    ulp = (_ordered_bits(g) - _ordered_bits(w)).abs()
    return dict(exact=int((g == w).sum()), total=int(g.numel()),
                max_ulp=int(ulp.max()) if ulp.numel() else 0,
                max_abs=float((g - w).abs().max()) if g.numel() else 0.0)


def _kept_blocks(mass: torch.Tensor, kb: int) -> torch.Tensor:
    from spatten_tpu_torch.ops.fused_decode import _kth_largest
    return (mass >= _kth_largest(mass, kb)) & (mass > 0.0)


def k1_stages(state, q, k_new, v_new, lengths, *, layer: int,
              threshold: float, v_block: int, keep_blocks: int,
              **flags) -> dict:
    """K1 and its plain version, stage by stage, bit for bit, from clones
    of ``state`` on the same inputs under ``flags`` (each stage read from
    the kernel's own outputs, by calling it again with other output
    flags):

    - ``scores``: the masked scaled scores (per-row presoftmax delta mode);
    - ``m``, ``den``: each row's softmax max and denominator (row stats);
    - ``probs``: the normalized probabilities per row (per-row prob delta
      mode), ``max_prob``, ``importance`` (the accumulator after the
      call, its live columns) and ``out``: exact / total elements, the
      largest ulp distance and |diff|;
    - ``keep`` (on the card): V blocks the kernel keeps against those the
      plain version's masses keep, flips / total."""
    from spatten_tpu_torch.ops import fused_decode as fd
    b, hq = q.shape[:2]
    rung = flags.get("cap_override") or state.capacity
    nvb = rung // v_block
    live = (torch.arange(rung, device=q.device)[None, None, :]
            < lengths[:, None, None]).expand(b, hq, rung)
    kw = dict(requant_threshold=threshold, layer=layer, v_block_size=v_block,
              **flags)

    def run(fn, keep=None, accumulate=False, **extra):
        st = state.clone()
        res = fn(q, st.cache.k, st.cache.v, k_new, v_new, lengths,
                 importance_in=st.importance if accumulate else None,
                 **dict(kw, **extra), **({} if keep is None
                                         else dict(keep_out=keep)))
        return res, st

    def side(fn, keep=None):
        (out, stats, _, _, (m, den)), st = run(
            fn, keep=keep, accumulate=True, return_row_stats=True)
        probs, scores = (run(fn, per_row_importance=True, **extra)[0][1]
                         .importance_delta for extra in
                         ({}, dict(importance_kind="presoftmax")))
        return dict(out=out, max_prob=stats.max_prob, m=m, den=den,
                    probs=probs, scores=scores,
                    importance=st.importance[layer][..., :rung])

    def plain_keep(p):
        """The V blocks the plain version keeps: its masses of the
        (bf16-rounded) numerators exp(s - m), by the kernel's rule."""
        e = torch.where(live, torch.exp(p["scores"] - p["m"][..., None]),
                        0.0)
        if flags.get("probs_bf16"):
            e = e.to(torch.bfloat16).to(torch.float32)
        mass = fd._ordered_sum(e.reshape(b, hq, nvb, v_block), -1)
        return _kept_blocks(mass, keep_blocks)

    # the kernel's keep masks exist only on the card (on the CPU the
    # wrapper runs the plain version, and the stage is left out)
    keep_k = (torch.zeros((b, hq, nvb), dtype=torch.uint8, device=q.device)
              if q.is_cuda and keep_blocks else None)
    kernel = side(fd.fused_decode_attention, keep_k)
    if q.is_cuda:
        torch.cuda.synchronize()
    imp_live = (torch.arange(rung, device=q.device)[None, None, :]
                < lengths[:, None, None]).expand_as(kernel["importance"])
    where = dict(scores=live, probs=live, importance=imp_live)

    plain = side(fd.fused_decode_attention_plain)
    rep = {k: _agreement(kernel[k], plain[k], where.get(k))
           for k in ("scores", "m", "den", "probs", "max_prob",
                     "importance", "out")}
    if keep_k is not None:
        got, want = keep_k.bool(), plain_keep(plain)
        rep["keep"] = dict(flips=int((got != want).sum()),
                           total=int(got.numel()))
    return rep


def split_threshold(max_prob: torch.Tensor) -> float:
    """A requant threshold midway across the widest gap between two of the
    middle half of the (nonzero) max probs: some heads fire, some not."""
    mp = torch.sort(max_prob.flatten()).values
    mp = mp[mp > 0].cpu()
    lo, hi = len(mp) // 4, max(len(mp) // 4 + 1, 3 * len(mp) // 4)
    gaps = mp[lo + 1:hi + 1] - mp[lo:hi]
    i = lo + int(torch.argmax(gaps)) + 1
    return float(mp[i - 1] + mp[i]) / 2


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


class _CpuReplay:
    """While active, ``transformer.forward`` first replays each call on
    the CPU from a copy of the state it was given (``params``: f32, on the
    CPU), then runs it; ``got`` / ``want`` collect the card's and the
    CPU's last-token logits [B, V] and ``shapes`` the token shapes.  A
    prefill chunk that replays from a CUDA graph
    (``engine.prefill_graph.PrefillGraph.run``) is replayed on the CPU
    the same way (``graphed`` counts them), and its capture runs the
    unpatched forward.  A tensor-parallel call (``tp_group``) replays its
    all-reduces on the CPU copies over the same group, so every rank must
    replay."""

    def __init__(self, params):
        from spatten_tpu_torch.engine.prefill_graph import PrefillGraph
        from spatten_tpu_torch.models import transformer as tr
        self.tr, self.params = tr, params
        self.run_forward = tr.forward
        self.graph_cls, self.run_graph = PrefillGraph, PrefillGraph.run
        self.got, self.want, self.shapes = [], [], []
        self.graphed = 0

    def _keep(self, got, ref, tokens) -> None:
        self.got.append(got.to("cpu"))
        self.want.append(ref)
        self.shapes.append(tuple(tokens.shape))

    def forward(self, p, cfg_, state, tokens, rope_tables=None,
                head_compact=None, **kw):
        cpu = torch.device("cpu")
        ref = self.run_forward(self.params, cfg_, state.clone(cpu),
                               tokens.to(cpu), _to(rope_tables, cpu),
                               _to(head_compact, cpu), **kw)[0]
        out = self.run_forward(p, cfg_, state, tokens, rope_tables,
                               head_compact, **kw)
        self._keep(out[0][:, -1], ref[:, -1], tokens)
        return out

    def graph_run(self, runner, state, tokens):
        cpu = torch.device("cpu")
        ref = self.run_forward(self.params, runner.cfg, state.clone(cpu),
                               tokens.to(cpu))[0]
        self.tr.forward = self.run_forward       # for the capture
        try:
            out = self.run_graph(runner, state, tokens)
        finally:
            self.tr.forward = self.forward
        self._keep(out[0], ref[:, -1], tokens)
        self.graphed += 1
        return out

    def __enter__(self):
        self.tr.forward = self.forward
        self.graph_cls.run = lambda runner, state, tokens: self.graph_run(
            runner, state, tokens)
        return self

    def __exit__(self, *exc):
        self.tr.forward = self.run_forward
        self.graph_cls.run = self.run_graph

    def errors(self) -> list:
        """(|card - CPU| logit max, call index, token shape) of every call,
        largest first (each call's batch may differ: admissions prefill
        at batch 1)."""
        out = []
        for i, (g, w) in enumerate(zip(self.got, self.want)):
            check(bool(torch.isfinite(g).all()), "non-finite logits")
            out.append((float((g - w).abs().max()), i, self.shapes[i]))
        return sorted(out, reverse=True)

    def logit_error(self) -> float:
        """The largest error over every call, within
        ``CPU_REPLAY_LOGIT_TOL``."""
        errs = self.errors()
        err = errs[0][0] if errs else 0.0
        check(err <= CPU_REPLAY_LOGIT_TOL, f"logits differ from the CPU's "
              f"by {err:.3e} (worst calls {errs[:5]})")
        return err


def check_against_cpu(cfg, params, prompt, new_tokens: int,
                      device: torch.device) -> dict:
    """Drive ``generate`` once on ``device`` and hold every forward call of
    that run (prefill chunk or decode step) against the CPU: while it
    runs, ``transformer.forward`` first replays the call on the CPU from a
    copy of the state it was given, then runs it.  K1 must launch once per
    layer and step where the card's gate admits the configuration
    (``transformer.decode_uses_kernel``) and never where it does not (the
    wrapper must not raise there); logits within
    ``CPU_REPLAY_LOGIT_TOL``, greedy tokens equal to the CPU's argmax
    where its top two logits are clear.  ``params``: f32, on the CPU."""
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    prompt = torch.as_tensor(prompt, dtype=torch.int64)
    params_dev = _to(params, device)
    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    with _CpuReplay(params) as rep:
        res = gen.generate(params_dev, cfg, prompt, new_tokens, device=device)
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    on_kernel = device.type == "cuda" and tr.decode_uses_kernel(cfg, "cuda")
    expect = cfg.model.num_layers * new_tokens if on_kernel else 0
    check(k1 == expect, f"K1 launched {k1} times, not {expect}")
    tokens = res.tokens.cpu()
    check(tuple(tokens.shape) == (prompt.shape[0], new_tokens),
          "token shape")
    err = rep.logit_error()
    # the tokens come from the prefill's last logits and every decode step
    # but the last
    chosen = torch.stack(rep.want)[-new_tokens - 1:-1]
    clear = _clear(chosen)
    check(bool((chosen.argmax(-1) == tokens.T)[clear].all()),
          "greedy tokens differ from the CPU's where its top-2 margin is "
          "clear")
    return dict(k1=k1, k2=k2, calls=len(rep.got), max_logit_err=err,
                clear_share=float(clear.float().mean()),
                prune_points=len(res.pruned_layers),
                requant_events=int(res.requant_events))


def check_server_against_cpu(cfg, params, requests, device: torch.device
                             ) -> dict:
    """Serve ``requests`` ((prompt, max_new_tokens), all submitted at
    once) with ``SpAttenServer`` on ``device`` and hold every forward call
    (each admission's prefill chunks at batch 1, those that replay from
    the server's CUDA graph included, each lockstep decode tick of the
    arena) against its replay on the CPU: the single-token
    calls (K1's: every decode tick, and a prompt's one-token last chunk)
    within ``CPU_REPLAY_LOGIT_TOL``, and the card's greedy token (each
    request's next token) equal to the CPU's argmax wherever the CPU's
    top-2 margin is clear, in every call.  The prefill chunks' logits are
    reported, not bounded: a batch-1 chunk quantizes up to
    ``prefill_chunk`` new rows per layer, each of whose int8 roundings the
    card's and the CPU's last-bit projection differences may flip at half
    a step (one step moves a logit by ~1e-3).  Every request
    finishes with exactly its budget and every slot ends free; K1
    launches once per layer and single-token forward (each decode tick,
    and a prompt's one-token last chunk) where the card's gate admits the
    configuration.  ``params``: f32, on the CPU."""
    from spatten_tpu_torch.engine.server import SpAttenServer
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops.compact_gather import gather_compact_rows
    from spatten_tpu_torch.ops.fused_decode import fused_decode_attention
    srv = SpAttenServer(_to(params, device), cfg, device=device)
    budget = {srv.submit(p, n): n for p, n in requests}
    fused_decode_attention.launches = 0
    gather_compact_rows.launches = 0
    with _CpuReplay(params) as rep:
        done = srv.run_to_completion()
    k1, k2 = fused_decode_attention.launches, gather_compact_rows.launches
    ticks = sum(shape == (srv.batch, 1) for shape in rep.shapes)
    # every single-token forward goes through K1: the decode ticks, and a
    # prompt's last prefill chunk where it is one token long
    steps = sum(shape[1] == 1 for shape in rep.shapes)
    on_kernel = device.type == "cuda" and tr.decode_uses_kernel(cfg, "cuda")
    expect = cfg.model.num_layers * steps if on_kernel else 0
    check(k1 == expect, f"K1 launched {k1} times, not {expect}")
    check(sorted(r.request_id for r in done) == sorted(budget),
          "not every request finished")
    check(all(len(r.generated) == budget[r.request_id] for r in done),
          "a request did not emit exactly its budget")
    check(sorted(srv.free_slots) == list(range(srv.batch)),
          f"slots {srv.free_slots} are not all free")
    errs = rep.errors()
    worst = errs[:5]
    err = max((e for e, _, shape in errs if shape[1] == 1), default=0.0)
    check(err <= CPU_REPLAY_LOGIT_TOL, f"single-token calls' logits differ "
          f"from the CPU's by {err:.3e} (worst calls {worst})")
    prefill_err = max((e for e, _, shape in errs if shape[1] > 1),
                      default=0.0)
    clear = same = 0
    for g, w in zip(rep.got, rep.want):
        c = _clear(w[None])[0]
        clear += int(c.sum())
        same += int((g.argmax(-1) == w.argmax(-1))[c].sum())
    check(same == clear, f"{clear - same} greedy tokens differ from the "
          "CPU's where its top-2 margin is clear")
    return dict(k1=k1, k2=k2, ticks=ticks, steps=steps, calls=len(rep.got),
                graphed=rep.graphed,
                max_logit_err=err, prefill_logit_err=prefill_err,
                worst_calls=worst, clear_share=clear / sum(
                    w.shape[0] for w in rep.want),
                order=[r.request_id for r in done])


def _clear(logits: torch.Tensor) -> torch.Tensor:
    """Where the top two logits [T, B, V] lie more than ``TOP2_MARGIN``
    apart: bool [T, B]."""
    top2 = logits.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > TOP2_MARGIN
