"""The port's perplexity curve (``spatten_tpu_torch.tools.ppl_curve``)
against the JAX tool (``tools/ppl_curve.py``, loaded by path once per
``PPL_MODEL``), on the CPU:

* ``model_cfg`` and every row's engine config field by field, at the
  three scales, with the JAX table's row names in order;
* ``dense_forward`` from JAX-initialised parameters (``convert``): logits
  within 1e-4 in f32;
* the loss and 5 training steps on the same numpy batches, Adam (tiny)
  and the gpt2s rule (optax's global-norm clip, then AdamW), parameters
  within 1e-5;
* ``make_batch``: the period structure, ~5% flips, the gpt2s train /
  evaluation split;
* ``tests/test_accuracy_delta.py``'s check, trained in torch;
* ``main`` at the tiny scale, every row of the JAX table in order.
"""

import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spatten_tpu.models import init_params as j_init_params

from spatten_tpu_torch.config import ModelConfig
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.eval import evaluate_perplexity
from spatten_tpu_torch.tools import ppl_curve as pc

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")

# the quant-profile rows of the JAX tool's table (tools/ppl_curve.py main)
PROFILE_ROWS = [
    "  profile 8-bit pass-1 (no requant)",
    "  profile 6-bit pass-1 (msb+lsb2, requant)",
    "  profile 4-bit pass-1, NO requant",
    "  profile mixed (6,8,4) per layer",
]


def small_corpus(path: Path, nbytes: int = 40_000) -> Path:
    rng = np.random.default_rng(3)
    words = ["the", "kernel", "returns", "a", "tensor", "of", "shape",
             "with", "each", "row", "scaled", "by", "its", "maximum"]
    text = " ".join(rng.choice(words, nbytes // 4))[:nbytes]
    path.write_text(text)
    return path


@pytest.fixture(scope="module")
def corpus_file(tmp_path_factory):
    return small_corpus(tmp_path_factory.mktemp("corpus") / "docs.txt")


def load_jax_tool(scale: str, corpus: Path):
    """The JAX tool as a fresh module under PPL_MODEL = scale (it reads
    the variable, and for gpt2s the corpus, when imported)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PPL_MODEL", scale)
        mp.setenv("PPL_CORPUS", str(corpus))
        spec = importlib.util.spec_from_file_location(
            f"jax_ppl_curve_{scale}", REPO / "tools" / "ppl_curve.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return mod


def jax_cap_for(scale: str, budget: int) -> int:
    # main's cap_for in tools/ppl_curve.py
    return min(1024 if scale in ("mid", "gpt2s") else 512,
               -(-(2 * budget + 32) // 8) * 8)


def jax_rows(mod, scale: str) -> list:
    """(row name, config) of the JAX tool's main, in order."""
    ev = mod.EVAL_LEN
    rows = [("dense fp (full context)",
             mod.engine_cfg(spatten=False, cap=512, budget=0))]
    for ratio in (0.75, 0.5, 0.35, 0.25, 0.15):
        budget = max(8, int(ev * ratio / 2))
        rows.append((f"spatten keep~{ratio:.2f} (4b+requant+vprune)",
                     mod.engine_cfg(spatten=True,
                                    cap=jax_cap_for(scale, budget),
                                    budget=budget)))
    budget = int(ev * 0.5 / 2)
    cap = jax_cap_for(scale, budget)
    for name, kw in zip(PROFILE_ROWS, (
            dict(layer_bits=(8,), requant=False), dict(layer_bits=(6,)),
            dict(requant=False), dict(layer_bits=(6, 8, 4)))):
        rows.append((name, mod.engine_cfg(spatten=True, cap=cap,
                                          budget=budget, **kw)))
    for vb in (4, 16, 32, 64):
        capv = max(cap, vb * 8)
        capv = -(-capv // vb) * vb
        rows.append((f"  v_block {vb} (cap {capv}, keep~0.5, vkeep 0.5)",
                     mod.engine_cfg(spatten=True, cap=capv, budget=budget,
                                    v_block=vb)))
    rows.append((f"dense @ {mod.STREAM_LEN} (2.5x trained ctx)",
                 mod.engine_cfg(spatten=False,
                                cap=2048 if scale != "tiny" else 1024,
                                budget=0)))
    rows.append((f"spatten rolling cache @ {mod.STREAM_LEN}",
                 mod.engine_cfg(spatten=True, cap=jax_cap_for(scale, 96),
                                budget=96)))
    return rows


@pytest.mark.parametrize("scale", ["tiny", "mid", "gpt2s"])
def test_configs_match_jax(scale, corpus_file):
    mod = load_jax_tool(scale, corpus_file)
    sc = pc.SCALES[scale]
    assert dataclasses.asdict(pc.model_cfg(sc)) == dataclasses.asdict(
        mod.model_cfg())
    assert (sc.vocab, sc.period, sc.seq, sc.eval_len, sc.stream_len) == (
        mod.VOCAB, mod.PERIOD, mod.SEQ, mod.EVAL_LEN, mod.STREAM_LEN)
    ours = pc.configs(sc) + pc.stream_configs(sc)
    theirs = jax_rows(mod, scale)
    assert [n for n, _ in ours] == [n for n, _ in theirs]
    for (name, a), (_, b) in zip(ours, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), name


def tiny_params(mod):
    """The tiny model (the JAX tool's config) initialised by JAX."""
    jm = mod.model_cfg()
    return jm, j_init_params(jm, jax.random.PRNGKey(0), dtype=jnp.float32)


def test_dense_forward_matches_jax(corpus_file):
    mod = load_jax_tool("tiny", corpus_file)
    jm, jp = tiny_params(mod)
    m = pc.SCALES["tiny"].model
    tokens = np.random.default_rng(5).integers(0, m.vocab_size, (2, 48))
    want = np.asarray(mod.dense_forward(jp, jm, jnp.asarray(tokens)))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    got = pc.dense_forward(tp, m, torch.as_tensor(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def jax_loss(mod, m):
    def loss_fn(params, tokens):
        logits = mod.dense_forward(params, m, tokens[:, :-1])
        logp = jax.nn.log_softmax(logits, axis=-1)
        return -jnp.take_along_axis(logp, tokens[:, 1:, None],
                                    axis=-1).mean()
    return loss_fn


def tree_get(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


@pytest.mark.parametrize("rule", ["adam", "clip+adamw"])
def test_training_steps_match_optax(rule, corpus_file):
    """5 steps from JAX-initialised parameters on the same numpy batches:
    each step's loss within 1e-5 relative and gradients within 1e-6 of
    JAX's; the update rule then fed JAX's gradients (Adam's first steps
    move a weight by ~lr whatever the size of its gradient, so a gradient
    near 0 whose last bits differ would move it differently), parameters
    within 1e-5 after 5 steps.  The clip+AdamW run has a step whose
    gradient norm passes 1.0 and is clipped."""
    mod = load_jax_tool("tiny", corpus_file)
    jm, jp = tiny_params(mod)
    m = pc.SCALES["tiny"].model
    sc = pc.SCALES["tiny"] if rule == "adam" else dataclasses.replace(
        pc.SCALES["gpt2s"], model=m)
    opt = (optax.adam(3e-3) if rule == "adam" else
           optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(6e-4, weight_decay=0.01)))
    loss_fn = jax_loss(mod, jm)
    state = opt.init(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for t in pc.leaves(tp):
        t.requires_grad_(True)
    topt = pc.optimizer(tp, sc)
    rng = np.random.default_rng(11)
    norms = []
    for _ in range(5):
        toks = rng.integers(0, m.vocab_size, (4, 33))
        loss, grads = jax.value_and_grad(loss_fn)(jp, jnp.asarray(toks))
        norms.append(float(optax.global_norm(grads)))
        updates, state = opt.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        topt.zero_grad(set_to_none=False)
        got = pc.loss_fn(tp, m, torch.as_tensor(toks))
        got.backward()
        assert float(got.detach()) == pytest.approx(float(loss), rel=1e-5)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            t = tree_get(tp, path)
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       atol=1e-6, rtol=1e-4)
            t.grad.copy_(torch.from_numpy(np.array(g)))
        pc.apply_grads(tp, topt, sc)
    if rule == "clip+adamw":
        assert max(norms) > 1.0, norms
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        np.testing.assert_allclose(
            tree_get(tp, path).detach().numpy(), np.asarray(leaf),
            atol=1e-5, rtol=1e-5, err_msg=jax.tree_util.keystr(path))


def test_clip_follows_optax():
    """optax's rule: scaled by max_norm / norm where norm >= max_norm,
    untouched below (torch's clip_grad_norm_ divides by norm + 1e-6)."""
    rng = np.random.default_rng(2)
    for scale_by in (0.1, 3.0):
        gs = [rng.standard_normal(s).astype(np.float32) * scale_by
              for s in ((3, 4), (5,))]
        want = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())[0]
        got = [torch.as_tensor(g.copy()) for g in gs]
        norm = pc.clip_by_global_norm_(got, 1.0)
        assert float(norm) == pytest.approx(float(np.sqrt(
            sum((g * g).sum() for g in gs))), rel=1e-6)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_make_batch_structure(corpus_file):
    sc = pc.SCALES["tiny"]
    x = pc.make_batch(np.random.default_rng(0), 16, sc.seq, sc=sc)
    assert x.shape == (16, sc.seq) and x.dtype == np.int64
    assert x.min() >= 0 and x.max() < sc.vocab
    # each row repeats its period; the tokens off the period's majority
    # are the ~5% flips (a flip may redraw the same token)
    base = np.array([[np.bincount(r[i::sc.period]).argmax()
                      for i in range(sc.period)] for r in x])
    off = x != np.tile(base, (1, sc.seq // sc.period + 1))[:, :sc.seq]
    assert 0.03 < off.mean() < 0.07
    gs = pc.SCALES["gpt2s"]
    corpus = pc.Corpus.load(str(corpus_file))
    assert corpus.split == int(len(corpus.data) * 0.98)
    seq = 64
    for eval_split in (False, True):
        b = pc.make_batch(np.random.default_rng(1), 64, seq, eval_split,
                          sc=gs, corpus=corpus)
        data = corpus.data.tobytes()
        for row in b:
            start = data.find(bytes(row.astype(np.uint8)))
            assert start >= 0
            if eval_split:
                assert start >= corpus.split
            else:
                assert start + seq <= corpus.split


ACC_MODEL = ModelConfig(vocab_size=64, hidden_size=48, num_layers=2,
                        num_heads=4, num_kv_heads=4, head_dim=12,
                        intermediate_size=96, max_position_embeddings=256)


def acc_engine_cfg(spatten: bool, cap: int, budget: int = 40):
    sc = dataclasses.replace(pc.SCALES["tiny"], model=ACC_MODEL)
    cfg = pc.engine_cfg(spatten=spatten, cap=cap, budget=budget, sc=sc,
                        prefill_chunk=8)
    return cfg


def test_trained_ppl_and_pruning_delta():
    """``tests/test_accuracy_delta.py`` in torch: the 2-layer model trained
    250 Adam steps on the period-8 copy language; dense ppl at 200 tokens
    far below chance (< 9), the full SpAtten pipeline at cache 128 within
    a log-ppl delta of 0.3, and a rolling cache of 64 below dense."""
    sc = dataclasses.replace(pc.SCALES["tiny"], model=ACC_MODEL, period=8,
                             seq=64, batch=16)
    params = pc.train(250, sc, device="cpu", log=lambda s: None)
    toks = torch.as_tensor(pc.make_batch(np.random.default_rng(42), 16, 64,
                                         sc=sc))
    with torch.no_grad():
        loss = float(pc.loss_fn(params, ACC_MODEL, toks))
    assert loss < 2.0, loss
    text = pc.make_batch(np.random.default_rng(99), 1, 200, sc=sc)[0]
    dense = evaluate_perplexity(params, acc_engine_cfg(False, 256), text,
                                device="cpu")
    assert dense.perplexity < 9.0, dense
    pruned = evaluate_perplexity(params, acc_engine_cfg(True, 128, 40), text,
                                 device="cpu")
    assert math.log(pruned.perplexity) - math.log(dense.perplexity) < 0.3
    streaming = evaluate_perplexity(params, acc_engine_cfg(True, 64, 24),
                                    text, device="cpu")
    assert streaming.perplexity < dense.perplexity


def test_main_prints_every_row_in_order(corpus_file):
    """``main`` at the tiny scale on the CPU (2 training steps): every row
    of the JAX table, in order, with a finite perplexity."""
    mod = load_jax_tool("tiny", corpus_file)
    printed = []
    rows = pc.main(device="cpu", steps=2, sc=pc.SCALES["tiny"],
                   out=printed.append, log=lambda s: None)
    names = [n for n, _ in jax_rows(mod, "tiny")]
    assert [r[0] for r in rows] == names
    assert all(math.isfinite(r[1]) and r[1] > 1.0 for r in rows)
    table = [line for line in printed if line.startswith("| ")
             and not line.startswith("| configuration")]
    assert [line.split(" | ")[0][2:] for line in table] == names


def test_main_raises_without_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.main(steps=0)


def test_ppl_phase_rehearsal(tmp_path):
    """``chip_smoke.phase_ppl``'s control flow on the CPU at a toy size: a
    corpus mined from a temporary package, a 2-layer byte model trained
    60 steps, the five runs (no launches counted on the CPU, where the
    wrappers run their plain versions) and the one-token runs against the
    plain versions."""
    import chip_smoke as cs
    pkg = tmp_path / "site" / "pkg"
    pkg.mkdir(parents=True)
    rng = np.random.default_rng(3)
    words = ("the kernel returns a tensor of shape with each row scaled by "
             "its maximum value").split()
    pkg.joinpath("mod.py").write_text("".join(
        f'def f{i}():\n    """{" ".join(rng.choice(words, 60))}"""\n\n'
        for i in range(60)))
    m = ModelConfig(vocab_size=256, hidden_size=32, num_layers=2,
                    num_heads=4, num_kv_heads=4, head_dim=8,
                    intermediate_size=64, max_position_embeddings=512)
    sc = pc.Scale("toy", m, 0, 64, 64, 160, 8)
    out = cs.phase_ppl(CPU, steps=60, sc=sc,
                       corpus_path=tmp_path / "corpus.txt",
                       roots=[str(tmp_path / "site")])
    assert 0 < out["corpus_mb"] < 0.1
    assert [k for k in out if k in cs.PPL_RUNS] == list(cs.PPL_RUNS)
    assert all(out[k]["k1"] == out[k]["k2"] == 0 for k in cs.PPL_RUNS)
    assert out["dense"]["ppl"] < 64
    assert out["vs_plain"][cs.PPL_RUNS[3]]["rel"] <= cs.PPL_NLL_RTOL
    assert out["vs_plain"][cs.PPL_RUNS[4]]["rel"] == 0.0
