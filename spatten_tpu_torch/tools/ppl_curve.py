"""Perplexity curve of a model trained from scratch: dense against SpAtten
at swept keep ratios, quantization profiles and V-block sizes, plus a
streaming row at 2.5x the trained context (port of ``tools/ppl_curve.py``).

No weights are in the repository, so this trains a Llama-style model
(f32, from seed 0) and streams held-out text through the engine
(``eval.evaluate_perplexity``: K1 for every one-token chunk on the card,
K2 for every cascade prune):

    PPL_MODEL=gpt2s python -m spatten_tpu_torch.tools.ppl_curve

prints a markdown table (one row per configuration, in the JAX tool's
order).  ``PPL_MODEL``: ``tiny`` (default; a periodic-copy language with
5% noise, 3 layers), ``mid`` (6 layers, 512 context) or ``gpt2s`` (GPT-2
small's geometry, 12 layers x 12 heads x 64, as a byte-level LM on real
English: the docstrings ``tools/extract_doc_corpus.py`` mines, built into
``PPL_CORPUS``, default ``build/doc_corpus.txt``, on first use).
``PPL_TRAIN_STEPS``: training steps (1200).

Training follows the JAX tool: Adam (lr 3e-3) at batch 16 for ``tiny``
and ``mid``; for ``gpt2s`` the global gradient norm clipped to 1.0 by
optax's rule (scaled by max_norm / norm only where norm >= max_norm),
then AdamW (6e-4, weight decay 0.01 on every parameter) at batch 32.  On
the card the training matmuls run in TF32.  Batches come from numpy
generators (seed 42 for training, 99 and 7 for the evaluation texts), so
the text and the numbers are the port's own, not the JAX tool's
``jax.random`` draws.  Runs on the card unless ``device="cpu"`` is asked
for.
"""

from __future__ import annotations

import math
import os
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from spatten_tpu_torch.config import (
    EngineConfig, ModelConfig, PruningConfig, QuantConfig, SpAttenConfig,
)
from spatten_tpu_torch.device import resolve_device
from spatten_tpu_torch.models.transformer import _mlp, _norm, init_params
from spatten_tpu_torch.ops import rope as rope_ops
from spatten_tpu_torch.tools import extract_doc_corpus


@dataclass(frozen=True)
class Scale:
    """One ``PPL_MODEL`` setting: its model, vocabulary, the synthetic
    language's period (0: the corpus), trained context, evaluation and
    streaming lengths, training batch."""

    name: str
    model: ModelConfig
    period: int
    seq: int
    eval_len: int
    stream_len: int
    batch: int

    @property
    def vocab(self) -> int:
        return self.model.vocab_size


SCALES = {
    "tiny": Scale("tiny", ModelConfig(
        vocab_size=64, hidden_size=64, num_layers=3, num_heads=4,
        num_kv_heads=4, head_dim=16, intermediate_size=128,
        max_position_embeddings=512), 12, 256, 256, 640, 16),
    "mid": Scale("mid", ModelConfig(
        vocab_size=128, hidden_size=256, num_layers=6, num_heads=8,
        num_kv_heads=8, head_dim=32, intermediate_size=512,
        max_position_embeddings=2048), 16, 512, 512, 1280, 16),
    # GPT-2 small's geometry (12 layers x 12 heads x 64, ~85M
    # parameters) as a byte-level model
    "gpt2s": Scale("gpt2s", ModelConfig(
        vocab_size=256, hidden_size=768, num_layers=12, num_heads=12,
        num_kv_heads=12, head_dim=64, intermediate_size=3072,
        max_position_embeddings=2048), 0, 512, 512, 1280, 32),
}


def scale(name: Optional[str] = None) -> Scale:
    """``name``'s scale, by default ``PPL_MODEL``'s (``tiny``)."""
    name = name or os.environ.get("PPL_MODEL", "tiny")
    if name not in SCALES:
        raise ValueError(f"PPL_MODEL {name!r}: one of {sorted(SCALES)}")
    return SCALES[name]


class Corpus:
    """The gpt2s text as bytes, its last 2% held out for evaluation."""

    def __init__(self, data: np.ndarray):
        self.data = data
        self.split = int(len(data) * 0.98)

    @classmethod
    def load(cls, path: Optional[str] = None) -> "Corpus":
        """The corpus at ``path`` (default ``PPL_CORPUS``, else
        ``build/doc_corpus.txt``), extracted first if it is missing."""
        path = Path(path or os.environ.get("PPL_CORPUS",
                                           extract_doc_corpus.DEFAULT_OUT))
        if not path.exists():
            n, total = extract_doc_corpus.extract(out_path=path)
            print(f"  corpus: {n} docstrings, {total / 1e6:.1f} MB -> "
                  f"{path}", file=sys.stderr, flush=True)
        return cls(np.frombuffer(path.read_bytes(), dtype=np.uint8))


def model_cfg(sc: Optional[Scale] = None) -> ModelConfig:
    return (sc or scale()).model


def make_batch(rng: np.random.Generator, batch: int, seqlen: int,
               eval_split: bool = False, sc: Optional[Scale] = None,
               corpus: Optional[Corpus] = None) -> np.ndarray:
    """int64 [batch, seqlen]: gpt2s windows of the corpus (training
    windows start before the held-out split, evaluation windows after
    it), else each row a random period-``period`` word repeated with 5%
    of its tokens replaced by noise."""
    sc = sc or scale()
    if sc.period == 0:
        lo, hi = ((corpus.split, len(corpus.data) - seqlen - 1) if eval_split
                  else (0, corpus.split - seqlen - 1))
        starts = rng.integers(lo, hi, batch)
        return corpus.data[starts[:, None] + np.arange(seqlen)].astype(
            np.int64)
    base = rng.integers(0, sc.vocab, (batch, sc.period))
    seq = np.tile(base, (1, -(-seqlen // sc.period)))[:, :seqlen]
    noise = rng.integers(0, sc.vocab, seq.shape)
    flip = rng.random(seq.shape) < 0.05
    return np.where(flip, noise, seq).astype(np.int64)


def dense_forward(params, m: ModelConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    """Causal dense logits f32 [B, S, V] of ``tokens`` [B, S]: the
    engine's model without a cache (RoPE at positions 0..S-1, rmsnorm,
    SiLU MLP), differentiable, for training."""
    b, s = tokens.shape
    f32 = torch.float32
    x = params["embed"][tokens].to(f32)
    cos, sin = rope_ops.rope_table(s, m.head_dim, m.rope_theta,
                                   tokens.device)
    pos = torch.arange(s, device=tokens.device)
    causal = pos[None, :] <= pos[:, None]
    for layer in range(m.num_layers):
        lp = {k: v[layer].to(f32) for k, v in params["layers"].items()}
        h = _norm(x, lp["attn_norm_w"], None, "rmsnorm", m.norm_eps)
        qh = (h @ lp["wq"]).reshape(b, s, m.num_heads, m.head_dim)
        kh = (h @ lp["wk"]).reshape(b, s, m.num_kv_heads, m.head_dim)
        vh = (h @ lp["wv"]).reshape(b, s, m.num_kv_heads, m.head_dim)
        qh = rope_ops.apply_rope(qh.transpose(1, 2), cos, sin, pos)
        kh = rope_ops.apply_rope(kh.transpose(1, 2), cos, sin, pos)
        vh = vh.transpose(1, 2)
        scores = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(
            m.head_dim)
        scores = torch.where(causal[None, None], scores, -1e30)
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        x = x + o.transpose(1, 2).reshape(b, s, -1) @ lp["wo"]
        h2 = _norm(x, lp["mlp_norm_w"], None, "rmsnorm", m.norm_eps)
        x = x + _mlp(h2, lp, "silu")
    x = _norm(x, params["final_norm_w"].to(f32), None, "rmsnorm",
              m.norm_eps)
    return x @ params["lm_head"].to(f32)


def loss_fn(params, m: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL of ``tokens`` [B, S] under ``dense_forward``."""
    logp = torch.log_softmax(dense_forward(params, m, tokens[:, :-1]), -1)
    return -torch.gather(logp, -1, tokens[:, 1:, None]).mean()


def leaves(params) -> list:
    """The parameter tensors of a tree, in key order."""
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in leaves(params[k])]
    return [params]


@torch.no_grad()
def clip_by_global_norm_(grads: list, max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: every gradient scaled by
    max_norm / norm where the global norm is not below max_norm (not
    torch's ``clip_grad_norm_``, which divides by norm + 1e-6).  Returns
    the norm."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


def optimizer(params, sc: Scale) -> torch.optim.Optimizer:
    """The JAX tool's optax transform: Adam at 3e-3, or for gpt2s AdamW
    at 6e-4 with weight decay 0.01 on every leaf (after the clip in
    ``apply_grads``); optax's b1, b2 and eps."""
    if sc.name == "gpt2s":
        return torch.optim.AdamW(leaves(params), lr=6e-4, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=0.01)
    return torch.optim.Adam(leaves(params), lr=3e-3, betas=(0.9, 0.999),
                            eps=1e-8)


def apply_grads(params, opt, sc: Scale) -> None:
    """The update from the gradients in ``.grad``: for gpt2s first the
    global-norm clip to 1.0."""
    if sc.name == "gpt2s":
        clip_by_global_norm_([t.grad for t in leaves(params)], 1.0)
    opt.step()


def train_step(params, opt, m: ModelConfig, sc: Scale,
               tokens: torch.Tensor) -> torch.Tensor:
    """One step on ``tokens``; returns the loss before it."""
    opt.zero_grad(set_to_none=False)
    loss = loss_fn(params, m, tokens)
    loss.backward()
    apply_grads(params, opt, sc)
    return loss.detach()


def train(steps: int = 1200, sc: Optional[Scale] = None,
          corpus: Optional[Corpus] = None,
          device: str | torch.device = "cuda", log=None, seed: int = 0):
    """f32 parameters of ``model_cfg(sc)`` trained ``steps`` steps from
    ``seed`` (0) on batches drawn from seed 42 + ``seed``; the loss is
    printed every 200 steps and at the end (to ``log``, default stderr)."""
    sc = sc or scale()
    dev = resolve_device(device)
    m = model_cfg(sc)
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    params = init_params(m, seed, dtype=torch.float32, device=dev)
    for t in leaves(params):
        t.requires_grad_(True)
    opt = optimizer(params, sc)
    rng = np.random.default_rng(42 + seed)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for i in range(steps):
            toks = torch.as_tensor(make_batch(rng, sc.batch, sc.seq, sc=sc,
                                              corpus=corpus), device=dev)
            loss = train_step(params, opt, m, sc, toks)
            if i % 200 == 0:
                log(f"  train step {i}: loss {float(loss):.3f}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if steps:
        log(f"  final loss {float(loss):.3f}")
    for t in leaves(params):
        t.requires_grad_(False)
    return params


def engine_cfg(*, spatten: bool, cap: int, budget: int, layer_bits=None,
               requant: bool = True, v_keep_ratio: float = 0.5,
               v_block: int = 4, sc: Optional[Scale] = None,
               prefill_chunk: int = 16) -> SpAttenConfig:
    """The engine under test: dense (no pruning, no quantization) or the
    full SpAtten pipeline (start 4, important and recent ``budget``, V
    pruning, 4-bit pass 1 with requant at 0.15 unless ``layer_bits``)."""
    m = model_cfg(sc)
    if spatten:
        pruning = PruningConfig(start_size=4, important_size=budget,
                                recent_size=budget, enable_v_pruning=True,
                                v_keep_ratio=v_keep_ratio,
                                v_block_size=v_block)
        quant = QuantConfig(enabled=True, enable_requant=requant,
                            requant_threshold=0.15 if requant else 0.0,
                            layer_bits=layer_bits)
    else:
        pruning = PruningConfig(enable_token_pruning=False,
                                enable_v_pruning=False)
        quant = QuantConfig(enabled=False, enable_requant=False)
    return SpAttenConfig(
        model=m, pruning=pruning, quant=quant,
        engine=EngineConfig(max_batch_size=1, cache_capacity=cap,
                            prefill_chunk=prefill_chunk),
    ).validate()


def cap_for(budget: int, sc: Optional[Scale] = None) -> int:
    """The cache of a keep budget: twice it plus 32, rounded up to 8,
    at most 1024 (512 for ``tiny``)."""
    sc = sc or scale()
    return min(512 if sc.name == "tiny" else 1024,
               -(-(2 * budget + 32) // 8) * 8)


def configs(sc: Optional[Scale] = None) -> list:
    """(row name, config) of every evaluated row but the streaming ones,
    in the JAX tool's order."""
    sc = sc or scale()
    rows = [("dense fp (full context)",
             engine_cfg(spatten=False, cap=512, budget=0, sc=sc))]
    for ratio in (0.75, 0.5, 0.35, 0.25, 0.15):
        budget = max(8, int(sc.eval_len * ratio / 2))
        rows.append((f"spatten keep~{ratio:.2f} (4b+requant+vprune)",
                     engine_cfg(spatten=True, cap=cap_for(budget, sc),
                                budget=budget, sc=sc)))
    budget = int(sc.eval_len * 0.5 / 2)
    cap = cap_for(budget, sc)
    for name, kw in (
            ("  profile 8-bit pass-1 (no requant)",
             dict(layer_bits=(8,), requant=False)),
            ("  profile 6-bit pass-1 (msb+lsb2, requant)",
             dict(layer_bits=(6,))),
            ("  profile 4-bit pass-1, NO requant", dict(requant=False)),
            ("  profile mixed (6,8,4) per layer",
             dict(layer_bits=(6, 8, 4)))):
        rows.append((name, engine_cfg(spatten=True, cap=cap, budget=budget,
                                      sc=sc, **kw)))
    for vb in (4, 16, 32, 64):
        capv = max(cap, vb * 8)
        capv = -(-capv // vb) * vb
        rows.append((f"  v_block {vb} (cap {capv}, keep~0.5, vkeep 0.5)",
                     engine_cfg(spatten=True, cap=capv, budget=budget,
                                v_block=vb, sc=sc)))
    return rows


def stream_configs(sc: Optional[Scale] = None) -> list:
    """(row name, config) of the two streaming rows at 2.5x the trained
    context: dense over the whole text, SpAtten's rolling cache."""
    sc = sc or scale()
    return [
        (f"dense @ {sc.stream_len} (2.5x trained ctx)",
         engine_cfg(spatten=False, cap=1024 if sc.name == "tiny" else 2048,
                    budget=0, sc=sc)),
        (f"spatten rolling cache @ {sc.stream_len}",
         engine_cfg(spatten=True, cap=cap_for(96, sc), budget=96, sc=sc)),
    ]


def eval_texts(sc: Scale, corpus: Optional[Corpus] = None):
    """(the evaluation text [eval_len], the streaming text [stream_len])."""
    text = make_batch(np.random.default_rng(99), 1, sc.eval_len,
                      eval_split=True, sc=sc, corpus=corpus)[0]
    stream = make_batch(np.random.default_rng(7), 1, sc.stream_len,
                        eval_split=True, sc=sc, corpus=corpus)[0]
    return text, stream


def main(device: str | torch.device = "cuda", steps: Optional[int] = None,
         sc: Optional[Scale] = None, corpus: Optional[Corpus] = None,
         out=print, log=None) -> list:
    """Train, evaluate every row and print the table (through ``out``);
    returns [(row name, perplexity, requant events per (token, layer, kv
    head))]."""
    from spatten_tpu_torch.eval import evaluate_perplexity
    sc = sc or scale()
    dev = resolve_device(device)
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    if sc.period == 0 and corpus is None:
        corpus = Corpus.load()
    steps = int(os.environ.get("PPL_TRAIN_STEPS", 1200)) if steps is None \
        else steps
    log(f"training {sc.name} model ({steps} steps) on {dev}...")
    params = train(steps, sc, corpus, dev, log)
    text, stream = eval_texts(sc, corpus)
    rows = []
    for (name, cfg), t in ([(c, text) for c in configs(sc)]
                           + [(c, stream) for c in stream_configs(sc)]):
        r = evaluate_perplexity(params, cfg, t, device=dev)
        m = cfg.model
        rate = r.requant_events / max(
            1, r.num_tokens * m.num_layers * m.num_kv_heads)
        rows.append((name, r.perplexity, rate))
        log(f"  {name:42s} ppl {r.perplexity:8.3f}  requant/head "
            f"{rate:.4f}")
    dense = rows[0][1]
    out("\n| configuration | ppl | log-ppl delta vs dense |")
    out("|---|---|---|")
    for name, ppl, _ in rows:
        out(f"| {name} | {ppl:.3f} | {np.log(ppl) - np.log(dense):+.4f} |")
    return rows


if __name__ == "__main__":
    main()
