"""How far whole models run through the kernels sit from the same models
run through the kernels' plain versions: the readings behind
``chip_smoke.py``'s tolerances for such comparisons.  Run from the
repository's root (it reuses ``chip_smoke.py``'s configurations and
checks), on the card::

    python -m spatten_tpu_torch.tools.plain_gap depths \\
        [--plain-from FILE] [DEPTH ...]
    python -m spatten_tpu_torch.tools.plain_gap ppl [--models N] [--texts N]

``depths``: the first decode window of one TP-4 rank's Llama-2-70B widths
(``chip_smoke.llama2_70b_rank_config``: batch 4, prompt 3072, 16 steps,
random bf16 weights from seed 0, drawn once at 80 layers and cut to each
depth), kernels against the plain versions (``chip_smoke.window_vs_plain``)
at each DEPTH (default 8 32 80).  ``--plain-from``: the same windows again
with K1's plain version read from another checkout's
``ops/fused_decode.py`` (loaded by path), the kernel unchanged: the
windows before a change to the plain version's arithmetic.

``ppl``: ``chip_smoke.phase_ppl``'s one-token run (gpt2s, keep 0.5,
``prefill_chunk`` 1, f32 K1 flags) for N models (``chip_smoke.PPL_STEPS``
training steps from init seeds 0 .. N-1) over N texts each (the held-out
split's windows from numpy seeds 99, 100, ...): the NLL through the
kernels against the plain versions' (``chip_smoke.plain_versions``).  On
the first model also each K1 call's output against its plain version's on
the same inputs (elements bit-equal, largest ulp distance and |diff|), and
two controls: the plain versions with a fault planted, whose NLL gap a
limit must exceed to catch it -- the probabilities rounded to bf16 (as
``probs_bf16``), and one V block fewer kept.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import sys
import time

import numpy as np
import torch

from spatten_tpu_torch.device import resolve_device


def _log(msg: str) -> None:
    print(msg, flush=True)


def _load_plain(path: str):
    """K1's plain version from the ``ops/fused_decode.py`` at ``path``."""
    spec = importlib.util.spec_from_file_location("plain_gap_other", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.fused_decode_attention_plain


@contextlib.contextmanager
def _plain_is(plain):
    """While active, ``chip_smoke.plain_versions`` takes ``plain`` as K1's
    plain version."""
    from spatten_tpu_torch.ops import fused_decode as fd
    saved = fd.fused_decode_attention_plain
    fd.fused_decode_attention_plain = plain
    try:
        yield
    finally:
        fd.fused_decode_attention_plain = saved


def depths(device="cuda", layers=(8, 32, 80), plain_from=None) -> dict:
    """{(plain, depth): window_vs_plain's report} for this checkout's plain
    version and, with ``plain_from``, that file's."""
    import chip_smoke as cs
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.ops import fused_decode as fd
    dev = resolve_device(device)
    full = cs.llama2_70b_rank_config(max(layers))
    params = tr.init_params(full.model, cs.SEED, dtype=torch.bfloat16,
                            device=dev)
    prompt = np.random.default_rng(cs.SEED).integers(
        0, full.model.vocab_size,
        (full.engine.max_batch_size, cs.SERVING_PROMPT))
    plains = {"this checkout": fd.fused_decode_attention_plain}
    if plain_from:
        plains[plain_from] = _load_plain(plain_from)
    out = {}
    for depth in layers:
        cfg = cs.llama2_70b_rank_config(depth)
        cut = dict(params, layers={k: v[:depth]
                                   for k, v in params["layers"].items()})
        steps = min(cs.MESH_WINDOW, gen.decode_window_steps(cfg))
        for name, plain in plains.items():
            rep = {}
            with _plain_is(plain):
                try:
                    cs.window_vs_plain(f"depth {depth}, plain version of "
                                       f"{name}", cfg, dev, cut, prompt,
                                       None, steps, report=rep)
                except AssertionError as e:
                    _log(f"depth {depth}, plain version of {name}: {e}")
            out[(name, depth)] = rep
            cs.free()
    _log("| depth | plain version | mean abs logit diff | argmax | "
         "logits bit-equal |")
    _log("|---|---|---|---|---|")
    for (name, depth), r in out.items():
        _log(f"| {depth} | {name} | {r['mean_err']!r} | {r['argmax']!r} | "
             f"{r['exact']!r} |")
    return out


def _per_call(agg: dict):
    """A stand-in for K1 in the model's decode steps that runs K1's plain
    version on copies of the call's inputs first, then the kernel, and
    adds how far the two outputs sit apart to ``agg``."""
    from spatten_tpu_torch import kernel_checks as kc
    from spatten_tpu_torch.ops import fused_decode as fd

    def planes(c):
        return type(c)(*(None if x is None else x.clone() for x in c))

    def both(q, k_quant, v_quant, k_new, v_new, lengths, **kw):
        imp = kw.get("importance_in")
        out_p = fd.fused_decode_attention_plain(
            q, planes(k_quant), planes(v_quant), k_new, v_new, lengths,
            **dict(kw, importance_in=None if imp is None else imp.clone()))[0]
        res = fd.fused_decode_attention(q, k_quant, v_quant, k_new, v_new,
                                        lengths, **kw)
        a = kc._agreement(res[0], out_p)
        agg["calls"] += 1
        agg["calls_exact"] += a["exact"] == a["total"]
        agg["exact"] += a["exact"]
        agg["total"] += a["total"]
        agg["max_ulp"] = max(agg["max_ulp"], a["max_ulp"])
        agg["max_abs"] = max(agg["max_abs"], a["max_abs"])
        return res
    return both


def _controls():
    """(name, context manager) of the planted faults: each swaps K1's
    plain version for a faulty one while ``plain_versions`` is active."""
    from spatten_tpu_torch.ops import fused_decode as fd
    plain, keep = fd.fused_decode_attention_plain, fd._v_keep_blocks

    def bf16_probs(*a, **kw):
        return plain(*a, **dict(kw, probs_bf16=True))

    @contextlib.contextmanager
    def one_block_fewer():
        fd._v_keep_blocks = lambda *a: max(1, keep(*a) - 1) if keep(*a) else 0
        try:
            yield
        finally:
            fd._v_keep_blocks = keep

    return (("probabilities rounded to bf16", _plain_is(bf16_probs)),
            ("one V block fewer kept", one_block_fewer()))


def ppl(device="cuda", models: int = 2, texts: int = 3, steps=None,
        sc=None, corpus=None) -> dict:
    """The one-token run's NLL gaps, kernels against plain versions, per
    (model seed, text seed); on model 0 the per-call output agreement and
    the controls' gaps.  ``sc``, ``corpus``: a rehearsal's scale and
    corpus (default gpt2s on ``build/doc_corpus.txt``)."""
    import chip_smoke as cs
    from spatten_tpu_torch.eval import evaluate_perplexity
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.tools import ppl_curve as pc
    dev = resolve_device(device)
    sc = sc or pc.SCALES["gpt2s"]
    if sc.period == 0 and corpus is None:
        corpus = pc.Corpus.load()
    steps = cs.PPL_STEPS if steps is None else steps
    cfg = cs.ppl_runs(sc)[cs.PPL_RUNS[3]]
    text_ids = [pc.make_batch(np.random.default_rng(99 + i), 1, sc.eval_len,
                              eval_split=True, sc=sc, corpus=corpus)[0]
                for i in range(texts)]

    def nll(params, t):
        return evaluate_perplexity(params, cfg, t, device=dev).nll

    gaps, controls, agg = [], {}, None
    for seed in range(models):
        t0 = time.perf_counter()
        params = pc.train(steps, sc, corpus, dev, log=lambda s: None,
                          seed=seed)
        _log(f"model {seed}: trained {steps} steps in "
             f"{time.perf_counter() - t0:.1f} s")
        for i, t in enumerate(text_ids):
            if seed == 0 and i == 0:
                agg = dict(calls=0, calls_exact=0, exact=0, total=0,
                           max_ulp=0, max_abs=0.0)
                saved = tr.fused_decode_attention
                tr.fused_decode_attention = _per_call(agg)
                try:
                    got = nll(params, t)
                finally:
                    tr.fused_decode_attention = saved
            else:
                got = nll(params, t)
            with cs.plain_versions():
                want = nll(params, t)
            rel = abs(got - want) / abs(want)
            gaps.append(dict(model=seed, text=99 + i, nll=got,
                             plain_nll=want, rel=rel))
            _log(f"model {seed}, text {99 + i}: NLL {got!r} kernels, "
                 f"{want!r} plain, relative gap {rel:.3e}")
            if seed == 0:
                for name, fault in _controls():
                    with fault, cs.plain_versions():
                        bad = nll(params, t)
                    r = abs(got - bad) / abs(bad)
                    controls.setdefault(name, []).append(r)
                    _log(f"  control, {name}: NLL {bad!r}, relative gap "
                         f"{r:.3e}")
        del params
        cs.free()
    worst = max(g["rel"] for g in gaps)
    _log(f"K1 per call, model 0, text 99 ({agg['calls']} calls): outputs "
         f"bit-equal in {agg['calls_exact']} calls; elements "
         f"{agg['exact']}/{agg['total']} bit-equal; largest "
         f"{agg['max_ulp']} ulp, |diff| {agg['max_abs']:.3e}")
    _log(f"largest kernels-vs-plain gap over {len(gaps)} runs: {worst:.3e}; "
         + "; ".join(f"control '{k}': smallest {min(v):.3e}, largest "
                     f"{max(v):.3e}" for k, v in controls.items()))
    return dict(gaps=gaps, controls=controls, per_call=agg, worst=worst)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    d = sub.add_parser("depths")
    d.add_argument("layers", nargs="*", type=int, default=[8, 32, 80])
    d.add_argument("--plain-from")
    p = sub.add_parser("ppl")
    p.add_argument("--models", type=int, default=2)
    p.add_argument("--texts", type=int, default=3)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.mode == "depths":
        depths(layers=tuple(args.layers), plain_from=args.plain_from)
    else:
        ppl(models=args.models, texts=args.texts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
