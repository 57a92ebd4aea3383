"""K1 at the GQA groups the CUDA kernel runs in a larger instance (3, 5,
6 and 7), in the port vs the JAX package, on the CPU.

K1's plain version against JAX ``fused_decode_attention(interpret=True)``
on the same numpy inputs under the serving flags (int8 queries, the bf16
probability plane, bf16 scales and importance, requant, V pruning, a
partly head-masked group; a 6-bit layer at groups 5 and 7): 6 query heads
over 2 kv heads of 64, 5 over 1 of 128, 12 over 2 of 64 and 7 over 1 of
128.  The Pallas kernel applies integer P·V only where its row count per
program tiles by 8 (``fused_decode.py:2050``: not at these shapes in
interpret mode), so those run without it, and two more shapes whose 8 kv
heads give 24 and 56 rows (groups 3 and 7 over 8 kv heads of 16) run
with it.  Tolerances, as ``tests/test_torch_serving.py``:

* planes after the append (int8, nibbles, 2-bit fields, bf16 scales):
  exact; need_requant exact (the threshold sits clear of every max
  prob);
* out and max prob: atol 2e-5, rtol 1e-4 (f32 summation order);
* importance: one bf16 step (rtol 2^-7);
* keep sets: each row's kept V blocks, derived by the kernel's counting
  rule from the per-row probability deltas of a second call in delta
  mode (``per_row_importance``), exact; the deltas within 2e-5 / 1e-4.

Then ``generate`` on ``chip_smoke.group_configs()``'s GQA-3 model (6 over
2 kv heads of 64, f32, 2 layers, capacity 64, head pruning keeping 1 of 2
kv heads, a prompt that prunes in prefill) in both packages from the same
weights (``convert.params_from_jax``): greedy tokens, layer lengths and
head masks exact; logits of the prefill and of every decode step within
1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine.policy import update_head_mask as j_update_head_mask
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)

T = torch.from_numpy
LAYER, CAP, VB, V_KEEP = 1, 64, 8, (24, 16)
LENGTHS = np.array([50, 31], np.int32)
TOL = dict(atol=2e-5, rtol=1e-4)

# name -> (query heads, kv heads, head_dim, 6-bit layer)
SHAPES = {
    "G3 6/2 x 64": (6, 2, 64, False),
    "G5 5/1 x 128 6-bit": (5, 1, 128, True),
    "G6 12/2 x 64": (12, 2, 64, False),
    "G7 7/1 x 128 6-bit": (7, 1, 128, True),
    "G3 24/8 x 16 pv_int8": (24, 8, 16, False),
    "G7 56/8 x 16 pv_int8": (56, 8, 16, False),
}


def jax_applies_pv_int8(hq: int) -> bool:
    """Whether the Pallas kernel in interpret mode (one program over every
    kv head: ``hq`` rows) runs integer P·V (``fused_decode.py:2050``)."""
    return hq % 8 == 0 or 8 % hq == 0


def f32np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def head_mask(hq: int, hkv: int) -> np.ndarray:
    """Every group alive but the last, whose first row is dead."""
    hm = np.ones((hkv, hq // hkv), bool)
    hm[-1, 0] = False
    return hm.reshape(hq)


def inputs(name):
    hq, hkv, d, six = SHAPES[name]
    rng = np.random.default_rng(sorted(SHAPES).index(name))
    b, L = len(LENGTHS), 2
    k = rng.standard_normal((L, b, hkv, CAP, d)).astype(np.float32)
    v = rng.standard_normal((L, b, hkv, CAP, d)).astype(np.float32)
    x = {n: rng.standard_normal(sh).astype(np.float32) for n, sh in
         (("q", (b, hq, 1, d)), ("k_new", (b, hkv, 1, d)),
          ("v_new", (b, hkv, 1, d)))}
    jk = jqz.quantize(jnp.asarray(k), with_lsb2=six)
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    jk = jk._replace(scale=jk.scale.astype(jnp.bfloat16))
    jv = jv._replace(scale=jv.scale.astype(jnp.bfloat16))
    jimp = jnp.asarray(rng.uniform(size=(L, b, hkv, CAP)), jnp.bfloat16)
    return x, jk, jv, jimp


def to_torch(q):
    """A JAX QuantizedKV -> the port's (bf16 scales kept bf16)."""
    def t(a):
        if a is None:
            return None
        if a.dtype == jnp.bfloat16:
            return T(f32np(a).copy()).bfloat16()
        return T(np.array(a))
    return tqz.QuantizedKV(*(t(a) for a in q))


def flags(name, threshold):
    hq, hkv, _, six = SHAPES[name]
    return dict(sm_scale=0.25, v_block_size=VB, v_keep=V_KEEP,
                requant_threshold=threshold, quantize_queries=True,
                probs_bf16=True, pv_int8=jax_applies_pv_int8(hq),
                quant_bits=(4, 6) if six else None)


def run_port(name, x, jk, jv, jimp, threshold, delta_mode=False):
    hq, hkv, _, _ = SHAPES[name]
    kw = flags(name, threshold)
    qb = kw.pop("quant_bits")
    imp = None if delta_mode else T(f32np(jimp).copy()).bfloat16()
    tk, tv = to_torch(jk), to_torch(jv)
    out, st, tk, tv = tfd.fused_decode_attention(
        T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), T(LENGTHS),
        layer=LAYER, head_mask=T(head_mask(hq, hkv)),
        quant_bits=None if qb is None else torch.tensor(qb),
        importance_in=imp, per_row_importance=delta_mode, **kw)
    return out, st, tk, tv, imp


def run_jax(name, x, jk, jv, jimp, threshold, delta_mode=False):
    hq, hkv, _, _ = SHAPES[name]
    kw = flags(name, threshold)
    qb = kw.pop("quant_bits")
    return jfd.fused_decode_attention(
        jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
        jnp.asarray(x["v_new"]), jnp.asarray(LENGTHS),
        layer=jnp.int32(LAYER), head_mask=jnp.asarray(head_mask(hq, hkv)),
        quant_bits=None if qb is None else jnp.asarray(qb, jnp.int32),
        importance_in=None if delta_mode else jimp,
        per_row_importance=delta_mode, interpret=True, **kw)


def split_threshold(max_prob: np.ndarray) -> float:
    """Midway across the widest gap between two live max probs."""
    mp = np.sort(max_prob.ravel())
    mp = mp[mp > 0]
    gaps = mp[1:] - mp[:-1]
    i = int(np.argmax(gaps))
    assert gaps[i] > 1e-4
    return float(mp[i] + mp[i + 1]) / 2


def keep_sets(delta: np.ndarray, kb: int):
    """Each row's kept V blocks by the kernel's counting rule (the blocks
    whose mass reaches the kb-th largest, mass > 0) from per-row
    probability deltas [B, Hq, C]; and the smallest gap between a row's
    kb-th and (kb+1)-th block mass among rows that keep any."""
    mass = delta.reshape(delta.shape[:2] + (-1, VB)).sum(-1)
    srt = -np.sort(-mass, axis=-1)
    kth, nxt = srt[..., kb - 1:kb], srt[..., kb:kb + 1]
    keep = (mass >= kth) & (mass > 0)
    live = kth[..., 0] > 0
    return keep, float((kth - nxt)[..., 0][live].min())


@pytest.mark.parametrize("name", list(SHAPES))
def test_k1_plain_matches_pallas_at_group(name):
    hq, hkv, d, six = SHAPES[name]
    group = hq // hkv
    assert group in (3, 5, 6, 7)
    assert tfd.instance_group(group) == (4 if group == 3 else 8)
    assert jax_applies_pv_int8(hq) == ("pv_int8" in name)
    x, jk, jv, jimp = inputs(name)
    threshold = split_threshold(
        run_port(name, x, jk, jv, jimp, 0.0)[1].max_prob.numpy())
    tout, tst, tk, tv, timp = run_port(name, x, jk, jv, jimp, threshold)
    jout, jst, jk2, jv2 = run_jax(name, x, jk, jv, jimp, threshold)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst.max_prob.numpy(),
                               np.asarray(jst.max_prob), **TOL)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    assert tst.need_requant.any() and not tst.need_requant.all()
    jimp2 = f32np(jst.importance_delta)
    hm = head_mask(hq, hkv)
    for bi, n in enumerate(LENGTHS):
        np.testing.assert_allclose(f32np(timp[LAYER, bi, :, :n]),
                                   jimp2[LAYER, bi, :, :n], atol=0,
                                   rtol=2 ** -7)
        for tq, jq in ((tk, jk2), (tv, jv2)):
            np.testing.assert_array_equal(tq.full[LAYER, bi, :n].numpy(),
                                          np.asarray(jq.full)[LAYER, bi, :n])
            np.testing.assert_array_equal(f32np(tq.scale[LAYER, bi, :, :n]),
                                          f32np(jq.scale[LAYER, bi, :, :n]))
        np.testing.assert_array_equal(
            tqz.unpack_msb(tk.msb[LAYER, bi]).numpy()[:n],
            np.asarray(jqz.unpack_msb(jk2.msb[LAYER, bi]))[:n])
        if six:
            np.testing.assert_array_equal(
                tqz.unpack_lsb2(tk.lsb2[LAYER, bi]).numpy()[:n],
                np.asarray(jqz.unpack_lsb2(jk2.lsb2[LAYER, bi]))[:n])
    # the partly alive group's dead row reads zero in both
    assert (tout.numpy()[:, ~hm] == 0).all()

    # keep sets, from a second call in per-row delta mode
    tdel = run_port(name, x, jk, jv, jimp, threshold, delta_mode=True)[1]
    jdel = run_jax(name, x, jk, jv, jimp, threshold, delta_mode=True)[1]
    tdel = tdel.importance_delta.numpy()
    jdel = np.asarray(jdel.importance_delta)
    assert tdel.shape == jdel.shape == (len(LENGTHS), hq, CAP)
    np.testing.assert_allclose(tdel, jdel, **TOL)
    kb = tfd._v_keep_blocks(V_KEEP, VB, CAP, LAYER)
    assert 0 < kb < CAP // VB
    tkeep, tgap = keep_sets(tdel, kb)
    jkeep, jgap = keep_sets(jdel, kb)
    assert min(tgap, jgap) > 1e-6        # no tie for the last kept block
    np.testing.assert_array_equal(tkeep, jkeep)
    assert not tkeep[:, ~hm].any()


def in_package(mod, obj):
    """``obj`` (a node of the port's config tree) rebuilt in ``mod``'s
    tree, whose class and field names are the same."""
    if not dataclasses.is_dataclass(obj):
        return obj
    return getattr(mod, type(obj).__name__)(**{
        f.name: in_package(mod, getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


@pytest.fixture(scope="module")
def gqa3_runs():
    cfg, batch, plen, new = chip_smoke.group_configs()[chip_smoke.GQA3_NAME]
    jc, tc = in_package(jcfg, cfg).validate(), in_package(tcfg, cfg)
    assert tc == cfg and tc.model.q_heads_per_kv == 3
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    prompt = np.random.default_rng(0).integers(
        0, jc.model.vocab_size, (batch, plen)).astype(np.int32)
    jres = jgen.generate(jparams, jc, jnp.asarray(prompt), new)

    # the port's run, every forward call's last logits kept
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    run_forward, tlogits = ttr.forward, []

    def forward(*args, **kw):
        out = run_forward(*args, **kw)
        tlogits.append(out[0][:, -1].numpy())
        return out

    ttr.forward = forward
    try:
        tres = tgen.generate(tparams, tc, T(prompt), new, device="cpu")
    finally:
        ttr.forward = run_forward

    # the JAX run again, step by step (its generate's schedule: the head
    # mask fixed after prefill, a prune before a window where due)
    jlast, jst, host = jgen.prefill(jparams, jc, j_init_state(jc, batch),
                                    jnp.asarray(prompt))
    jst = jax.jit(j_update_head_mask, static_argnums=0)(jc, jst)
    step = jax.jit(jtr.forward, static_argnums=(1,))
    tok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    jlogits, toks, maxps = [np.asarray(jlast)], [], []
    window = tgen.decode_window_steps(tc)
    for w0 in range(0, new, window):
        n = min(window, new - w0)
        layers, host = jgen.prune_schedule_step(jc, host, n)
        if layers:
            jst = jgen.maybe_prune(jc, jst, n, static_layers=layers)[0]
        for _ in range(n):
            logits, jst, aux = step(jparams, jc, jst, tok[:, None])
            toks.append(np.asarray(tok))
            maxps.append(np.asarray(aux.max_probs))
            jlogits.append(np.asarray(logits[:, -1]))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    np.testing.assert_array_equal(np.stack(toks, 1), np.asarray(jres.tokens))
    n_prefill = -(-plen // cfg.engine.prefill_chunk)
    return dict(cfg=cfg, jres=jres, tres=tres, new=new, plen=plen,
                jlogits=np.stack(jlogits),
                tlogits=np.stack(tlogits[n_prefill - 1:]),
                maxps=np.stack(maxps))


def test_gqa3_generate_tokens_lengths_masks_exact(gqa3_runs):
    r = gqa3_runs
    jres, tres, cfg = r["jres"], r["tres"], r["cfg"]
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    np.testing.assert_array_equal(tres.state.layer_lengths.numpy(),
                                  np.asarray(jres.state.layer_lengths))
    np.testing.assert_array_equal(tres.state.head_mask.numpy(),
                                  np.asarray(jres.state.head_mask))
    assert int(tres.requant_events) == int(jres.requant_events) > 0
    # the prompt outgrows the capacity: the run prunes in prefill
    assert r["plen"] > cfg.engine.cache_capacity and tres.pruned_layers
    # one of the two kv heads survives head pruning in each layer
    alive = tres.state.head_mask.reshape(cfg.model.num_layers, 2, 3).any(-1)
    assert alive.sum(-1).tolist() == [1] * cfg.model.num_layers
    # the requant decisions sit clear of the threshold
    gap = np.abs(r["maxps"] - cfg.quant.requant_threshold)
    assert gap[r["maxps"] > 0].min() >= 1e-4


def test_gqa3_generate_logits_within_1e3(gqa3_runs):
    r = gqa3_runs
    # the prefill's last logits, then every decode step's
    assert r["tlogits"].shape == r["jlogits"].shape == (
        r["new"] + 1,) + r["jlogits"].shape[1:]
    np.testing.assert_allclose(r["tlogits"], r["jlogits"], atol=1e-3,
                               rtol=0)
