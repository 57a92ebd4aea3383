"""The port's workload traces, cost model, run metrics and perplexity
(``spatten_tpu_torch.engine.trace``, ``perf.cost_model``,
``engine.metrics``, ``eval.perplexity``) against the JAX package's, on
the CPU, from the same weights (``convert.params_from_jax``).

* ``collect_trace``: rows equal field for field on a tiny configuration
  that prunes (cascade), requantizes and prunes heads on the fly; the CSV
  the port writes is the JAX package's, byte for byte, and reads back
  equal in both packages.
* ``estimate_cost`` and ``dense_bytes``: equal between the packages, each
  through the native library and through numpy, at explicit
  ``HwParams`` (the JAX package's defaults and the port's card preset).
* ``collect_run_metrics``: equal summaries of the two packages'
  ``generate`` results.
* ``evaluate_perplexity``: NLL within 1e-5 relative, requant events and
  token counts exact.
None of these reads the hardware simulator's published workloads.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine import metrics as jmetrics
from spatten_tpu.engine import trace as jtrace
from spatten_tpu.eval import perplexity as jppl
from spatten_tpu.models import transformer as jtr
from spatten_tpu.perf import cost_model as jcm

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine import metrics as tmetrics
from spatten_tpu_torch.engine import trace as ttrace
from spatten_tpu_torch.eval import perplexity as tppl
from spatten_tpu_torch.perf import cost_model as tcm

torch.set_num_threads(1)


def trace_cfg(mod, **quant):
    """Tiny: cascade pruning with a layer decay, V pruning, requant, and
    head pruning re-derived every 4 decode steps."""
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=8, v_keep_ratio=0.5,
                                  v_block_size=4,
                                  cascade_layer_ratios=(1.0, 0.5),
                                  enable_head_pruning=True, head_keep=1,
                                  head_update_interval=4),
        quant=mod.QuantConfig(requant_threshold=0.2, **quant),
        engine=mod.EngineConfig(max_batch_size=1, cache_capacity=32,
                                prefill_chunk=8),
    ).validate()


@pytest.fixture(scope="module")
def params():
    jc = trace_cfg(jcfg)
    jp = jtr.init_params(jc.model, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def traces(params):
    jp, tp = params
    prompt = np.random.default_rng(1).integers(0, 255, (1, 30)).astype(
        np.int32)
    jrows = jtrace.collect_trace(jp, trace_cfg(jcfg), jnp.asarray(prompt),
                                 max_new_tokens=12)
    trows = ttrace.collect_trace(tp, trace_cfg(tcfg), prompt,
                                 max_new_tokens=12, device="cpu")
    return jrows, trows


def test_collect_trace_rows_equal(traces):
    jrows, trows = traces
    assert len(trows) == len(jrows)
    assert [dataclasses.astuple(r) for r in trows] == \
        [dataclasses.astuple(r) for r in jrows]
    # the configuration prunes, requantizes and prunes heads
    kf = np.array([r.key_fetch_num for r in trows])
    assert kf.max() <= 32 and len(set(kf.tolist())) > 2
    assert any(r.if_requant for r in trows)
    assert not all(r.if_requant for r in trows)
    assert any(r.if_topk for r in trows)
    # head pruning drops one of the two kv heads once the on-the-fly
    # update has fired
    assert 12 * 2 < len(trows) < 12 * 2 * 2


def test_trace_csv_roundtrip(traces, tmp_path):
    jrows, trows = traces
    tp, jpath = tmp_path / "port.csv", tmp_path / "jax.csv"
    ttrace.write_csv(trows, str(tp))
    jtrace.write_csv(jrows, str(jpath))
    assert tp.read_bytes() == jpath.read_bytes()
    assert ttrace.HEADER == jtrace.HEADER and len(ttrace.HEADER) == 17
    back = ttrace.read_csv(str(tp))
    assert back == trows
    assert [dataclasses.astuple(r) for r in jtrace.read_csv(str(tp))] == \
        [dataclasses.astuple(r) for r in back]


def test_read_csv_skips_banners(tmp_path):
    row = ttrace.TraceRow(0, 1, 2, 64.0, 100, 90, 4, 16, 0.05, True, 4,
                          45, 8, True, False, True, 45)
    p = tmp_path / "banner.csv"
    p.write_text("configs/gpt2/x.yml,,,\n" + ",".join(ttrace.HEADER) + "\n"
                 + ",".join(row.as_csv()) + "\n" + ",".join(ttrace.HEADER)
                 + "\n" + ",".join(row.as_csv()) + "\n")
    assert ttrace.read_csv(str(p)) == [row, row]


def synthetic_rows(mod):
    return [mod.TraceRow(i, l, h, 64.0, 993, 900 - 10 * l, 6, 16, 0.05,
                         (l + h) % 3 == 0, 4, 204, 6, True, False, True, 204)
            for i in range(4) for l in range(3) for h in range(2)]


HW = {"JAX defaults": dataclasses.asdict(jcm.HwParams()),
      "card preset": dataclasses.asdict(tcm.H100_SXM),
      "weights": dict(hbm_gbps=1000.0, peak_tflops=100.0,
                      step_overhead_us=10.0, weight_bytes_per_step=4e9,
                      scale_bytes_per_elem=2.0, requant_refetch_factor=1.0)}


@pytest.mark.parametrize("rows_from", ["synthetic", "collected"])
@pytest.mark.parametrize("hw", list(HW))
def test_cost_model_equals_jax(traces, rows_from, hw):
    if rows_from == "synthetic":
        jrows, trows = synthetic_rows(jtrace), synthetic_rows(ttrace)
    else:
        jrows, trows = traces
    jhw, thw = jcm.HwParams(**HW[hw]), tcm.HwParams(**HW[hw])
    want = jcm.estimate_cost(jrows, jhw)
    got = tcm.estimate_cost(trows, thw)
    assert tcm._load_lib() is not None and jcm._load_lib() is not None
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # the numpy versions agree with each other and with the native one
    np_t = tcm._estimate_numpy(tcm._columns(trows), thw)
    np_j = jcm._estimate_numpy(jcm._columns(jrows), jhw)
    assert dataclasses.asdict(np_t) == dataclasses.asdict(np_j)
    assert np_t.iterations == got.iterations
    np.testing.assert_allclose(np_t.total_bytes, got.total_bytes,
                               rtol=1e-12)
    np.testing.assert_allclose(np_t.total_seconds, got.total_seconds,
                               rtol=1e-12)
    assert tcm.dense_bytes(trows) == jcm.dense_bytes(jrows) > 0


def test_cost_model_numpy_path_without_the_library(monkeypatch, traces):
    """Where the native library cannot load, the numpy version prices the
    trace (the same numbers)."""
    _, trows = traces
    native = tcm.estimate_cost(trows)
    dense = tcm.dense_bytes(trows)
    monkeypatch.setattr(tcm, "_lib", None)
    monkeypatch.setattr(tcm, "_lib_tried", True)
    fallback = tcm.estimate_cost(trows)
    assert fallback.iterations == native.iterations
    np.testing.assert_allclose(fallback.total_seconds, native.total_seconds,
                               rtol=1e-12)
    assert tcm.dense_bytes(trows) == dense


def test_card_preset_is_the_h100():
    hw = tcm.H100_SXM
    assert (hw.hbm_gbps, hw.peak_tflops) == (3350.0, 989.0)
    assert hw.step_overhead_us > 0
    assert tcm.estimate_cost([]).iterations == 0


def test_run_metrics_equal(params):
    jp, tp = params
    cfg_j, cfg_t = trace_cfg(jcfg), trace_cfg(tcfg)
    # the prompt prunes in prefill, so no two kv heads' masses tie when the
    # head mask is first derived
    prompt = np.random.default_rng(2).integers(0, 255, (2, 40)).astype(
        np.int32)
    cfg_j = dataclasses.replace(cfg_j, engine=dataclasses.replace(
        cfg_j.engine, max_batch_size=2))
    cfg_t = dataclasses.replace(cfg_t, engine=dataclasses.replace(
        cfg_t.engine, max_batch_size=2))
    jres = jgen.generate(jp, cfg_j, jnp.asarray(prompt), 10)
    tres = tgen.generate(tp, cfg_t, prompt, 10, device="cpu")
    np.testing.assert_array_equal(tres.tokens.numpy(),
                                  np.asarray(jres.tokens))
    want = jmetrics.collect_run_metrics(cfg_j, jres, batch=2,
                                        prompt_tokens=40, wall_seconds=0.5)
    got = tmetrics.collect_run_metrics(cfg_t, tres, batch=2,
                                       prompt_tokens=40, wall_seconds=0.5)
    assert got.summary() == want.summary()
    assert got.requant_events > 0 and got.head_keep_fraction == 0.5


def ppl_cfg(mod, chunk, quant):
    cfg = trace_cfg(mod, **quant)
    return dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, prefill_chunk=chunk)).validate()


@pytest.mark.parametrize("chunk,quant", [
    (8, {}), (1, {}), (8, {"enabled": False, "enable_requant": False})])
def test_perplexity_matches_jax(params, chunk, quant):
    """Chunks of 8 (the prefill path) and of 1 (every token a decode
    step through K1, which requantizes), and with quantization off."""
    jp, tp = params
    tokens = np.random.default_rng(3).integers(0, 255, 61)
    want = jppl.evaluate_perplexity(jp, ppl_cfg(jcfg, chunk, quant), tokens)
    got = tppl.evaluate_perplexity(tp, ppl_cfg(tcfg, chunk, quant), tokens,
                                   device="cpu")
    assert got.num_tokens == want.num_tokens == 60
    assert got.requant_events == want.requant_events
    assert (got.requant_events > 0) is (chunk == 1)
    np.testing.assert_allclose(got.nll, want.nll, rtol=1e-5)
    np.testing.assert_allclose(got.perplexity, want.perplexity, rtol=1e-4)
