"""The port's bench (``spatten_tpu_torch.tools.bench``) against the JAX
repository's root ``bench.py`` (loaded by path; reloaded under
``SPATTEN_BENCH_MODEL=gpt2-small``), on the CPU.

``build_cfg`` is compared field by field at the bench's own widths; the
rest runs at a small width (both modules' ``shard_model_cfg`` patched to 8
layers, hidden 128, 4 heads of 32), capacity 512, batch 2, with the JAX
model's int8 weights carried across by ``convert.params_from_jax``.  The
JAX side runs K1 as the JAX tests do on the CPU (the Pallas kernel in
interpret mode, which its decode gate picks there):

* ``build_cfg``: every field equal, spatten and dense, both models,
  capacities 4096 / 8192 / 16384, with and without
  ``SPATTEN_BENCH_LAYER_BITS``;
* ``warm_state``: lengths exact (the dense headroom reads
  ``SPATTEN_BENCH_STEPS``);
* ``warm_cache_content``: planes and scales byte-exact at contrasts 1, 5
  and 19, with and without a 6-bit layer profile (the fill drops the
  2-bit plane in both);
* ``calibrate_requant``: within 1e-5 relative;
* ``time_decode`` at 4 steps, 1 repeat (spatten, spatten with a 6-bit
  layer profile, dense): the greedy tokens of every step (recorded around
  ``transformer.forward``), ``requant_events``, the head mask and the
  lengths exact;
* ``measure_prune``: one refill-and-prune of the bench's run, the
  compacted planes exact on live rows; the amortized formula equal on
  the same event times at the serving rungs; the port's runs
  (``prune_runs``) there and at the small width;
* ``measure_prefill``: the prefill logits within 1e-3.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.models.weight_quant import quantize_params as j_quantize
from spatten_tpu.pruning import token_pruning as jtp

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine.state import init_state as t_init_state
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.pruning import token_pruning as ttp
from spatten_tpu_torch.tools import bench as tb

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
CAP, BATCH, STEPS = 512, 2, 4
SMALL = dict(vocab_size=256, hidden_size=128, num_layers=8, num_heads=4,
             num_kv_heads=4, head_dim=32, intermediate_size=256,
             tie_word_embeddings=True)


def load_jax_bench(name="jax_bench"):
    """The root bench.py as a fresh module (it reads SPATTEN_BENCH_MODEL
    when imported); the JAX settings it changes are put back."""
    keep = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    spec = importlib.util.spec_from_file_location(name, REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in keep.items():
        jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jb():
    return load_jax_bench()


@pytest.fixture
def small(jb, monkeypatch):
    """Both benches at the small width; STEPS decode steps a window."""
    monkeypatch.setattr(jb, "shard_model_cfg",
                        lambda: jcfg.ModelConfig(**SMALL))
    monkeypatch.setattr(tb, "shard_model_cfg",
                        lambda: tcfg.ModelConfig(**SMALL))
    monkeypatch.setenv("SPATTEN_BENCH_STEPS", str(STEPS))
    monkeypatch.delenv("SPATTEN_BENCH_LAYER_BITS", raising=False)
    return jb


@pytest.fixture(scope="module")
def params():
    """(JAX int8 params, the port's copy on the CPU)."""
    jp = j_quantize(jtr.init_params(jcfg.ModelConfig(**SMALL),
                                    jax.random.PRNGKey(0)))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), CPU)


def as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("model", ["llama2-7b-tp8", "gpt2-small"])
@pytest.mark.parametrize("bits", [None, "4,4,6,6,8,8,8,8"])
def test_build_cfg_fields(model, bits, monkeypatch):
    monkeypatch.setenv("SPATTEN_BENCH_MODEL", model)
    if bits is None:
        monkeypatch.delenv("SPATTEN_BENCH_LAYER_BITS", raising=False)
    else:
        n = 12 if model == "gpt2-small" else 8
        bits = ",".join((bits.split(",") * 2)[:n])
        monkeypatch.setenv("SPATTEN_BENCH_LAYER_BITS", bits)
    mod = load_jax_bench(f"jax_bench_{model.replace('-', '_')}")
    assert tb.bench_layers() == (mod.BENCH_LAYERS, mod.FULL_LAYERS)
    assert as_dict(tb.shard_model_cfg()) == as_dict(mod.shard_model_cfg())
    for cache in (4096, 8192, 16384):
        for spatten in (True, False):
            want = as_dict(mod.build_cfg(spatten, cache, 16))
            got = as_dict(tb.build_cfg(spatten, cache, 16))
            assert got == want, (cache, spatten)


def j_warm(jb, cfg, contrast=19.0):
    st = j_init_state(cfg, batch=BATCH)
    return jb.warm_cache_content(cfg, jb.warm_state(cfg, st),
                                 contrast=contrast)


def t_warm(cfg, contrast=19.0):
    st = t_init_state(cfg, batch=BATCH, device=CPU)
    return tb.warm_cache_content(cfg, tb.warm_state(cfg, st),
                                 contrast=contrast)


@pytest.mark.parametrize("spatten", [True, False])
def test_warm_state_lengths(small, spatten):
    jc = small.build_cfg(spatten, CAP, BATCH)
    tc = tb.build_cfg(spatten, CAP, BATCH)
    js = small.warm_state(jc, j_init_state(jc, batch=BATCH))
    ts = tb.warm_state(tc, t_init_state(tc, batch=BATCH, device=CPU))
    np.testing.assert_array_equal(ts.lengths.numpy(), np.asarray(js.lengths))
    np.testing.assert_array_equal(ts.layer_lengths.numpy(),
                                  np.asarray(js.layer_lengths))


def planes(cache):
    return {f"{kv}.{name}": getattr(getattr(cache, kv), name)
            for kv in ("k", "v") for name in ("full", "msb", "scale", "lsb2")}


def as_bytes(x):
    a = np.asarray(x) if not isinstance(x, torch.Tensor) else (
        x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
        else x.numpy())
    if a.dtype.name == "bfloat16":
        a = a.view(np.int16)
    return a


@pytest.mark.parametrize("bits", [None, "4,6,6,8,4,6,8,8"])
@pytest.mark.parametrize("spatten", [True, False])
def test_warm_cache_content_bytes(small, monkeypatch, spatten, bits):
    if bits:
        monkeypatch.setenv("SPATTEN_BENCH_LAYER_BITS", bits)
    jc = small.build_cfg(spatten, CAP, BATCH)
    tc = tb.build_cfg(spatten, CAP, BATCH)
    if bits and spatten:
        # the 6-bit layers' state holds a 2-bit plane before the fill
        assert t_init_state(tc, BATCH, CPU).cache.k.lsb2 is not None
    for contrast in (1.0, 5.0, 19.0):
        js, ts = j_warm(small, jc, contrast), t_warm(tc, contrast)
        jp, tp = planes(js.cache), planes(ts.cache)
        for name in jp:
            if jp[name] is None:
                assert tp[name] is None, name
                continue
            np.testing.assert_array_equal(as_bytes(tp[name]),
                                          as_bytes(jp[name]),
                                          err_msg=f"{name} at {contrast}")
        assert tp["k.lsb2"] is None        # dropped by the fill, as in JAX
        np.testing.assert_array_equal(as_bytes(ts.importance),
                                      as_bytes(js.importance))


def test_calibrate_requant(small, params):
    jp, tparams = params
    jc = small.build_cfg(True, CAP, BATCH)
    tc = tb.build_cfg(True, CAP, BATCH)
    for q in (0.15, 0.5):
        want = small.calibrate_requant(jc, jp, quantile=q)
        got = tb.calibrate_requant(tc, tparams, quantile=q, device=CPU)
        assert got == pytest.approx(want, rel=1e-5), q


def record_tokens(monkeypatch, small):
    """Greedy tokens of every decode step of both packages' forward."""
    seen = {"jax": [], "torch": []}
    j_forward, t_forward = jtr.forward, ttr.forward

    def j_rec(params, cfg, state, tokens, *a, **k):
        logits, state, aux = j_forward(params, cfg, state, tokens, *a, **k)
        if tokens.shape[1] == 1:
            jax.debug.callback(lambda t: seen["jax"].append(np.asarray(t)),
                               jnp.argmax(logits[:, -1], axis=-1),
                               ordered=True)
        return logits, state, aux

    def t_rec(params, cfg, state, tokens, *a, **k):
        logits, state, aux = t_forward(params, cfg, state, tokens, *a, **k)
        if tokens.shape[1] == 1:
            seen["torch"].append(torch.argmax(logits[:, -1], -1).numpy())
        return logits, state, aux

    monkeypatch.setattr(jtr, "forward", j_rec)
    monkeypatch.setattr(ttr, "forward", t_rec)
    return seen


@pytest.mark.parametrize("spatten,bits", [(True, None),
                                          (True, "4,6,6,8,4,6,8,8"),
                                          (False, None)])
def test_time_decode(small, params, monkeypatch, spatten, bits):
    jp, tparams = params
    if bits:
        # 6-bit layers whose 2-bit plane the fill dropped read 4 bits
        monkeypatch.setenv("SPATTEN_BENCH_LAYER_BITS", bits)
    jc = small.build_cfg(spatten, CAP, BATCH)
    tc = tb.build_cfg(spatten, CAP, BATCH)
    if spatten:
        # a threshold that fires on some heads and not others
        thr = tb.calibrate_requant(tc, tparams, quantile=0.4, device=CPU)
        jc = dataclasses.replace(jc, quant=dataclasses.replace(
            jc.quant, requant_threshold=thr))
        tc = dataclasses.replace(tc, quant=dataclasses.replace(
            tc.quant, requant_threshold=thr))
    seen = record_tokens(monkeypatch, small)
    _, js = small.time_decode(jc, jp, STEPS, repeats=1)
    timing = {}
    _, ts = tb.time_decode(tc, tparams, STEPS, repeats=1, device=CPU,
                           timing=timing)
    jax.effects_barrier()
    assert len(seen["torch"]) == len(seen["jax"]) == 2 * STEPS
    np.testing.assert_array_equal(np.stack(seen["torch"]),
                                  np.stack(seen["jax"]))
    assert int(ts.requant_events) == int(js.requant_events)
    if spatten:
        assert int(ts.requant_events) > 0
    np.testing.assert_array_equal(ts.head_mask.numpy(),
                                  np.asarray(js.head_mask))
    np.testing.assert_array_equal(ts.layer_lengths.numpy(),
                                  np.asarray(js.layer_lengths))
    assert set(timing) == {"host_ms_per_step", "device_ms_per_step",
                           "first_window_s"}


def test_measure_prune_state(small):
    jc = small.build_cfg(True, CAP, BATCH)
    tc = tb.build_cfg(True, CAP, BATCH)
    layers = (0, 3)
    caps = ttp.layer_capacities(tc)
    js, ts = j_warm(small, jc), t_warm(tc)
    # give the importance a ranking (the bench's zeros tie everywhere)
    rng = np.random.default_rng(0)
    imp = rng.uniform(size=tuple(ts.importance.shape)).astype(np.float32)
    js = js._replace(importance=jnp.asarray(imp, js.importance.dtype))
    ts.importance.copy_(torch.from_numpy(imp).to(ts.importance.dtype))
    # the bench's refill (the selected layers to their rung), then the prune
    sel = np.zeros((8, 1), bool)
    sel[list(layers)] = True
    ll = np.where(sel, np.asarray(caps)[:, None],
                  np.asarray(js.layer_lengths))
    js = js._replace(layer_lengths=jnp.asarray(ll, jnp.int32),
                     lengths=jnp.asarray(ll.max(0), jnp.int32))
    js, _ = jgen.maybe_prune(jc, js, 1, static_layers=layers)
    ts = ts._replace(layer_lengths=torch.from_numpy(ll.astype(np.int32)),
                     lengths=torch.from_numpy(ll.max(0).astype(np.int32)))
    ts, _ = tgen.maybe_prune(tc, ts, 1, static_layers=layers)
    np.testing.assert_array_equal(ts.layer_lengths.numpy(),
                                  np.asarray(js.layer_lengths))
    jpl, tpl = planes(js.cache), planes(ts.cache)
    for l in range(8):
        for b in range(BATCH):
            n = int(ts.layer_lengths[l, b])
            for name in ("k.full", "v.full"):
                np.testing.assert_array_equal(
                    as_bytes(tpl[name][l, b, :n]),
                    as_bytes(jpl[name][l, b, :n]), err_msg=f"{name} {l}")
            for name in ("k.scale", "v.scale"):
                np.testing.assert_array_equal(
                    as_bytes(tpl[name][l, b, :, :n]),
                    as_bytes(jpl[name][l, b, :, :n]), err_msg=f"{name} {l}")
            np.testing.assert_array_equal(
                as_bytes(ts.importance[l, b, :, :n]),
                as_bytes(js.importance[l, b, :, :n]))


def test_measure_prune_amortized_and_runs(small, monkeypatch, params):
    # the formula at the serving rungs, on the same event times
    monkeypatch.undo()
    jb = small
    jc, tc = jb.build_cfg(True, 16384, 32), tb.build_cfg(True, 16384, 32)
    caps_l = jtp.layer_capacities(jc)
    assert ttp.layer_capacities(tc) == caps_l
    keeps_l = jtp.layer_keep_max_static(jc.pruning, jc.model.num_layers)
    events = {c: 0.5 + 0.1 * i for i, c in enumerate(sorted(set(caps_l)))}
    # one run per rung after layer 0's (the JAX bench's event_by_rung)
    assert tb.prune_runs(tc) == [(tuple(range(8)), 8), ((0,), 8)] + [
        ((caps_l.index(c),), 4) for c in dict.fromkeys(caps_l[1:])
        if c != caps_l[0]]
    want = sum(events[caps_l[l]] / max(caps_l[l] - keeps_l[l], 1)
               for l in range(jc.model.num_layers))
    assert tb.amortized_ms(tc, events) == pytest.approx(want, rel=1e-12)
    assert len(set(caps_l)) > 1
    # the port's runs at the small width: every layer, layer 0, no other
    # rung (capacity 512 has one)
    monkeypatch.setattr(tb, "shard_model_cfg",
                        lambda: tcfg.ModelConfig(**SMALL))
    tc = tb.build_cfg(True, CAP, BATCH)
    assert tb.prune_runs(tc, 1) == [(tuple(range(8)), 1), ((0,), 1)]
    worst, steady, amort = tb.measure_prune(tc, params[1], reps=1,
                                            device=CPU)
    assert worst > 0 and steady > 0
    assert amort == pytest.approx(tb.amortized_ms(tc, {CAP: steady}))
    dense = tb.build_cfg(False, CAP, BATCH)
    assert tb.measure_prune(dense, params[1], device=CPU) == (0.0, 0.0, 0.0)


@pytest.mark.parametrize("spatten", [True, False])
def test_measure_prefill_logits(small, params, monkeypatch, spatten):
    jp, tparams = params
    jc = small.build_cfg(spatten, CAP, BATCH)
    tc = tb.build_cfg(spatten, CAP, BATCH)
    got = {}
    j_prefill, t_prefill = jgen.prefill, tgen.prefill

    def j_rec(*a, **k):
        out = j_prefill(*a, **k)
        got["jax"] = np.asarray(out[0])
        return out

    def t_rec(*a, **k):
        out = t_prefill(*a, **k)
        got["torch"] = out[0].numpy()
        return out

    monkeypatch.setattr(jgen, "prefill", j_rec)
    monkeypatch.setattr(tgen, "prefill", t_rec)
    plen = 192
    small.measure_prefill(jc, jp, plen, reps=0)
    tps, ttft = tb.measure_prefill(tc, tparams, plen, reps=1, device=CPU)
    assert got["torch"].shape == (BATCH, SMALL["vocab_size"])
    np.testing.assert_allclose(got["torch"], got["jax"], atol=1e-3,
                               rtol=1e-3)
    assert tps > 0 and ttft > 0
