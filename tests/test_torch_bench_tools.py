"""The port's bench tools against the JAX repository's, and the two API
pieces they need, on the CPU:

* each tool's ladder: the JAX tool's ``main`` (``tools/profile_fused.py``,
  ``bisect_bench.py``, ``vprune_sweep.py``, ``prefill_diag.py``,
  ``profile_decode.py`` in every mode, ``microbench.py`` in every mode,
  loaded by path) and the port's, with the timers (``time_decode``,
  ``measure_prefill``, ``calibrate_requant``, ``timed_window``,
  ``timed_kernel_only``, ``kernel_case``, ``scan_time`` / ``loop_time``),
  ``init_params`` and ``quantize_params`` replaced by recorders: the
  configs they would time, field by field, and every printed line are
  equal;
* ``engine.generate.maybe_update_head_mask(window)`` against JAX's, at
  windows that cross a multiple of the interval and windows that do not;
* K1's ``_skip_append`` (the plain version) against the Pallas kernel in
  interpret mode with ``_skip_append=True``: the int8 and nibble planes
  unchanged (exact), the scales as JAX writes them, out and max prob
  within 2e-5 / 1e-4, importance likewise, and the V keep sets (from a
  per-row delta-mode call) exact;
* the new modules import neither ``jax``, ``spatten_tpu``, ``bench`` nor
  ``tools``.
"""

import ast
import contextlib
import dataclasses
import importlib.util
import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spatten_tpu.models.weight_quant as jwq
from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.engine.state import init_state as j_init_state
from spatten_tpu.models import transformer as jtr
from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import state_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.models import weight_quant as twq
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz
from spatten_tpu_torch.tools import (
    bench as tb, bisect_bench, microbench, prefill_diag, profile_decode,
    profile_fused, vprune_sweep,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
T = torch.from_numpy
TOL = dict(atol=2e-5, rtol=1e-4)
NEW_MODULES = ["bench", "profile_fused", "bisect_bench", "vprune_sweep",
               "prefill_diag", "profile_decode", "microbench"]
JAX_CONFIG_KEYS = ("jax_compilation_cache_dir",
                   "jax_persistent_cache_min_compile_time_secs")


def load_jax(path: str, name: str):
    """A JAX script as a fresh module; the JAX settings it changes when
    imported are put back."""
    keep = {k: getattr(jax.config, k) for k in JAX_CONFIG_KEYS}
    spec = importlib.util.spec_from_file_location(name, REPO / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for k, v in keep.items():
        jax.config.update(k, v)
    return mod


@pytest.fixture(scope="module")
def jbench():
    """The root bench.py, registered as ``bench`` (the JAX tools import it
    by that name)."""
    mod = load_jax("bench.py", "bench")
    sys.modules["bench"] = mod
    yield mod
    sys.modules.pop("bench", None)


def cfg_key(cfg):
    return dataclasses.asdict(cfg)


class Recorder:
    """Stand-ins for the timers and the weights: each call appends
    (what, config, options) and returns a fixed value."""

    def __init__(self):
        self.calls = []

    def time_decode(self, cfg, params, steps, repeats=3, contrast=19.0,
                    **kw):
        self.calls.append(("time_decode", cfg_key(cfg), steps, repeats,
                           contrast))
        return cfg.engine.max_batch_size * 100.0, None

    def calibrate(self, cfg, params, quantile=0.15, **kw):
        self.calls.append(("calibrate", cfg_key(cfg), quantile))
        return 0.0123

    def prefill(self, cfg, params, prompt_len, reps=2, **kw):
        self.calls.append(("prefill", cfg_key(cfg), prompt_len, reps))
        return 1000.0, 50.0

    def init_params(self, cfg, *a, **kw):
        self.calls.append(("init_params", cfg_key(cfg)))
        return {"w": np.zeros(1, np.float32)}

    def quantize(self, params):
        self.calls.append(("quantize",))
        return params

    def window(self, cfg, params, steps=64, repeats=3, **kw):
        self.calls.append(("window", cfg_key(cfg), steps, repeats))
        return 2.5

    def kernel_only(self, cfg, steps=64, repeats=3, skip_append=False,
                    no_importance=False, **kw):
        self.calls.append(("kernel_only", cfg_key(cfg), steps, repeats,
                           skip_append, no_importance))
        return 1.5

    def kernel_case(self, name, **kw):
        kw.pop("device", None)
        kw.pop("hpp", None)          # None in every JAX call
        self.calls.append(("kernel_case", name, sorted(kw.items())))
        return 1e-5

    def loop(self, fn, carry, n, *a, **kw):
        self.calls.append(("loop", n))
        return 1e-3


def patch_jax(mp, rec, jbench, mod=None):
    mp.setattr(jbench, "time_decode", rec.time_decode)
    mp.setattr(jbench, "calibrate_requant", rec.calibrate)
    mp.setattr(jbench, "measure_prefill", rec.prefill)
    mp.setattr(jtr, "init_params", rec.init_params)
    mp.setattr(jwq, "quantize_params", rec.quantize)
    if mod is not None and hasattr(mod, "quantize_params"):
        mp.setattr(mod, "quantize_params", rec.quantize)


def patch_port(mp, rec):
    mp.setattr(tb, "time_decode", rec.time_decode)
    mp.setattr(tb, "calibrate_requant", rec.calibrate)
    mp.setattr(tb, "measure_prefill", rec.prefill)
    mp.setattr(ttr, "init_params", rec.init_params)
    mp.setattr(twq, "quantize_params", rec.quantize)


def captured(fn, *a, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        fn(*a, **kw)
    return out.getvalue(), err.getvalue()


# tool -> (JAX script, port module, argv or environment)
TOOLS = {
    "profile_fused": ("tools/profile_fused.py", profile_fused, None),
    "bisect_bench": ("tools/bisect_bench.py", bisect_bench, None),
    "vprune_sweep": ("tools/vprune_sweep.py", vprune_sweep, []),
    "vprune_sweep 8192x16": ("tools/vprune_sweep.py", vprune_sweep,
                             ["8192", "16"]),
    "prefill_diag": ("tools/prefill_diag.py", prefill_diag, []),
    "prefill_diag 8192 16384 8": ("tools/prefill_diag.py", prefill_diag,
                                  ["8192", "16384", "8"]),
}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_ladder_matches_jax(tool, jbench, monkeypatch):
    path, port, argv = TOOLS[tool]
    jrec, trec = Recorder(), Recorder()
    if tool == "bisect_bench":
        for k, v in (("CACHE", "8192"), ("BATCH", "8"), ("STEPS", "16")):
            monkeypatch.setenv(k, v)
    if argv is not None:
        monkeypatch.setattr(sys, "argv", [path] + argv)
    with monkeypatch.context() as mp:
        mod = load_jax(path, f"jax_{tool.split()[0]}")
        patch_jax(mp, jrec, jbench, mod)
        jout = captured(mod.main)
    with monkeypatch.context() as mp:
        patch_port(mp, trec)
        kw = {} if argv is None else {"argv": argv}
        tout = captured(port.main, device=CPU, **kw)
    assert len(trec.calls) > 4
    assert trec.calls == jrec.calls
    assert tout == jout


PROFILE_MODES = [["spatten"], ["dense"], ["kernel"], ["kernel-dense"],
                 ["kernel-ladder"], ["spatten", "8192", "16"]]


@pytest.mark.parametrize("argv", PROFILE_MODES, ids=" ".join)
def test_profile_decode_ladder_matches_jax(argv, jbench, monkeypatch):
    monkeypatch.delenv("SPATTEN_PROFILE_TRACE", raising=False)
    jrec, trec = Recorder(), Recorder()
    monkeypatch.setattr(sys, "argv", ["profile_decode.py"] + argv)
    with monkeypatch.context() as mp:
        mod = load_jax("tools/profile_decode.py", "jax_profile_decode")
        patch_jax(mp, jrec, jbench)
        mp.setattr(mod, "timed_window", jrec.window)
        mp.setattr(mod, "timed_kernel_only", jrec.kernel_only)
        jout = captured(mod.main)
    with monkeypatch.context() as mp:
        patch_port(mp, trec)
        mp.setattr(profile_decode, "timed_window", trec.window)
        mp.setattr(profile_decode, "timed_kernel_only", trec.kernel_only)
        tout = captured(profile_decode.main, argv, device=CPU)
    assert trec.calls == jrec.calls
    assert tout == jout


@pytest.mark.parametrize("mode", ["kernel", "8k", "floor", "bw"])
def test_microbench_ladder_matches_jax(mode, monkeypatch):
    jrec, trec = Recorder(), Recorder()
    with monkeypatch.context() as mp:
        mod = load_jax("tools/microbench.py", "jax_microbench")
        mp.setattr(mod, "kernel_case", jrec.kernel_case)
        mp.setattr(mod, "scan_time", jrec.loop)
        jout = captured({"kernel": mod.bench_kernel, "8k": mod.bench_8k,
                         "floor": mod.bench_floor, "bw": mod.bench_bw}[mode])
    with monkeypatch.context() as mp:
        mp.setattr(microbench, "kernel_case", trec.kernel_case)
        mp.setattr(microbench, "loop_time", trec.loop)
        if mode == "bw":
            tout = captured(microbench.bench_bw, device=CPU)
        else:
            tout = captured(microbench.main, [mode], device=CPU)
    assert len(trec.calls) > 4
    assert trec.calls == jrec.calls
    assert tout == jout


# ------------------------------------------------ maybe_update_head_mask
def head_cfgs(interval):
    kw = dict(model=dict(vocab_size=64, hidden_size=64, num_layers=2,
                         num_heads=8, num_kv_heads=4, head_dim=16,
                         intermediate_size=64),
              pruning=dict(start_size=2, important_size=16, recent_size=8,
                           v_block_size=8, enable_head_pruning=True,
                           head_keep=2, head_update_interval=interval),
              engine=dict(max_batch_size=2, cache_capacity=64,
                          prefill_chunk=16))
    out = []
    for m in (jcfg, tcfg):
        out.append(m.SpAttenConfig(
            model=m.ModelConfig(**kw["model"]),
            pruning=m.PruningConfig(**kw["pruning"]),
            engine=m.EngineConfig(**kw["engine"])).validate())
    return out


# (lengths, window): 32 and 40 are multiples of 8; a window of n at clock
# c fires where c % 8 < n
HEAD_CASES = [((32, 20), 1), ((33, 20), 1), ((39, 30), 1), ((38, 30), 4),
              ((35, 20), 4), ((36, 30), 4), ((40, 12), 8), ((47, 12), 8),
              ((45, 12), 6), ((46, 12), 6)]


@pytest.mark.parametrize("interval", [8, 0])
def test_maybe_update_head_mask_window(interval):
    jc, tc = head_cfgs(interval)
    rng = np.random.default_rng(interval)
    fired = []
    for lengths, window in HEAD_CASES:
        js = j_init_state(jc, batch=2)
        imp = rng.uniform(size=tuple(js.importance.shape)).astype(np.float32)
        ll = np.asarray(lengths, np.int32)
        js = js._replace(importance=jnp.asarray(imp), lengths=jnp.asarray(ll),
                         layer_lengths=jnp.asarray(np.stack([ll, ll])))
        ts = state_from_jax(jax.tree.map(np.asarray, js), CPU)
        before = np.asarray(js.head_mask).copy()
        jm = np.asarray(jgen.maybe_update_head_mask(jc, js,
                                                    window=window).head_mask)
        tm = tgen.maybe_update_head_mask(tc, ts, window=window
                                         ).head_mask.numpy()
        np.testing.assert_array_equal(tm, jm, err_msg=str((lengths, window)))
        fired.append(not (jm == before).all())
        assert fired[-1] == tgen.head_mask_due(tc, max(lengths), window)
    if interval:
        assert fired == [max(l) % 8 < w for l, w in HEAD_CASES]
        assert any(fired) and not all(fired)
    else:
        assert not any(fired)
    # the one-step form is the window-1 form
    js = js._replace(lengths=jnp.asarray(np.asarray([40, 3], np.int32)))
    ts = state_from_jax(jax.tree.map(np.asarray, js), CPU)
    np.testing.assert_array_equal(
        tgen.maybe_update_head_mask(tc, ts).head_mask.numpy(),
        np.asarray(jgen.maybe_update_head_mask(jc, js).head_mask))


# --------------------------------------------------------- _skip_append
def f32np(x):
    return (x.to(torch.float32).numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x).astype(np.float32))


def k1_case(seed, lsb2):
    rng = np.random.default_rng(seed)
    b, hq, hkv, cap, d = 2, 4, 2, 64, 16
    k = rng.standard_normal((1, b, hkv, cap, d)).astype(np.float32)
    v = rng.standard_normal((1, b, hkv, cap, d)).astype(np.float32)
    x = dict(q=rng.standard_normal((b, hq, 1, d)).astype(np.float32),
             k_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32),
             v_new=rng.standard_normal((b, hkv, 1, d)).astype(np.float32),
             imp=rng.uniform(size=(1, b, hkv, cap)).astype(np.float32))
    jk = jqz.quantize(jnp.asarray(k), with_lsb2=lsb2)
    jv = jqz.quantize(jnp.asarray(v), with_msb=False)
    return x, jk, jv


def torch_planes(q):
    return tqz.QuantizedKV(*(None if a is None else T(np.array(a)) for a in q))


# name -> (flags, 6-bit layer)
SKIP_CASES = {
    "requant_vprune": (dict(requant_threshold=0.3, v_keep=24), False),
    "serving_flags": (dict(requant_threshold=0.3, v_keep=24,
                           quantize_queries=True, pv_int8=True,
                           probs_bf16=True), False),
    "six_bit": (dict(requant_threshold=0.3, v_keep=24,
                     quant_bits=(6,)), True),
    "dense": (dict(quant_enabled=False, quantize_queries=True), False),
}


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_k1_skip_append_plain_matches_pallas(case):
    flags, lsb2 = SKIP_CASES[case]
    x, jk, jv = k1_case(sorted(SKIP_CASES).index(case), lsb2)
    lengths = np.asarray([50, 31], np.int32)
    qb = flags.pop("quant_bits", None)
    kw = dict(sm_scale=0.25, v_block_size=8, layer=0, **flags)

    def port(delta_mode=False):
        tk, tv = torch_planes(jk), torch_planes(jv)
        before = [t.clone() for t in (tk.full, tk.msb, tk.lsb2, tv.full)
                  if t is not None]
        imp = None if delta_mode else T(x["imp"].copy())
        out = tfd.fused_decode_attention(
            T(x["q"]), tk, tv, T(x["k_new"]), T(x["v_new"]), T(lengths),
            importance_in=imp, per_row_importance=delta_mode,
            quant_bits=None if qb is None else torch.tensor(qb),
            _skip_append=True, **kw)
        after = [t for t in (tk.full, tk.msb, tk.lsb2, tv.full)
                 if t is not None]
        for a, bb in zip(after, before):
            assert torch.equal(a, bb)     # no plane byte written
        return out, imp, (tk, tv)

    def pallas(delta_mode=False):
        return jfd.fused_decode_attention(
            jnp.asarray(x["q"]), jk, jv, jnp.asarray(x["k_new"]),
            jnp.asarray(x["v_new"]), jnp.asarray(lengths),
            importance_in=None if delta_mode else jnp.asarray(x["imp"]),
            per_row_importance=delta_mode,
            quant_bits=None if qb is None else jnp.asarray(qb, jnp.int32),
            interpret=True, _skip_append=True, **kw)

    (tout, tst, _, _), timp, (tk, tv) = port()
    jout, jst, jk2, jv2 = pallas()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst.max_prob.numpy(), np.asarray(jst.max_prob),
                               **TOL)
    np.testing.assert_array_equal(tst.need_requant.numpy(),
                                  np.asarray(jst.need_requant))
    for bi, n in enumerate(lengths):
        np.testing.assert_allclose(f32np(timp[0, bi, :, :n]),
                                   f32np(jst.importance_delta)[0, bi, :, :n],
                                   **TOL)
        for tq, jq in ((tk, jk2), (tv, jv2)):
            # the planes as JAX leaves them (unwritten), the scales as it
            # writes them (one f32 ulp: XLA's amax / 127)
            np.testing.assert_array_equal(tq.full[0, bi].numpy(),
                                          np.asarray(jq.full)[0, bi])
            np.testing.assert_allclose(f32np(tq.scale[0, bi]),
                                       f32np(jq.scale[0, bi]), rtol=2e-7,
                                       atol=0)
        for name in ("msb", "lsb2"):
            if getattr(jk2, name) is not None:
                np.testing.assert_array_equal(
                    getattr(tk, name)[0, bi].numpy(),
                    np.asarray(getattr(jk2, name))[0, bi])
    # the step equals the appending step's results, not a non-appending one
    tk2, tv2 = torch_planes(jk), torch_planes(jv)
    app = tfd.fused_decode_attention(
        T(x["q"]), tk2, tv2, T(x["k_new"]), T(x["v_new"]), T(lengths),
        importance_in=T(x["imp"].copy()),
        quant_bits=None if qb is None else torch.tensor(qb), **kw)
    np.testing.assert_array_equal(tout.numpy(), app[0].numpy())

    # keep sets, from a per-row delta-mode call
    if flags.get("v_keep"):
        tdel = port(delta_mode=True)[0][1].importance_delta.numpy()
        jdel = np.asarray(pallas(delta_mode=True)[1].importance_delta)
        np.testing.assert_allclose(tdel, jdel, **TOL)
        kb = tfd._v_keep_blocks(flags["v_keep"], 8, 64, 0)
        mass_t = tdel.reshape(2, 4, -1, 8).sum(-1)
        mass_j = jdel.reshape(2, 4, -1, 8).sum(-1)
        for mass in (mass_t, mass_j):
            srt = -np.sort(-mass, axis=-1)
            assert (srt[..., kb - 1] - srt[..., kb]).min() > 1e-6
        keep_t = mass_t >= -np.sort(-mass_t, axis=-1)[..., kb - 1:kb]
        keep_j = mass_j >= -np.sort(-mass_j, axis=-1)[..., kb - 1:kb]
        np.testing.assert_array_equal(keep_t, keep_j)


# ------------------------------------------------------------- imports
FORBIDDEN = ("jax", "spatten_tpu", "bench", "tools")


@pytest.mark.parametrize("name", NEW_MODULES)
def test_new_modules_import_no_jax(name):
    path = REPO / "spatten_tpu_torch" / "tools" / f"{name}.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]] if node.level == 0 \
                else []
        else:
            continue
        assert not set(roots) & set(FORBIDDEN), (name, roots)
    code = (f"import sys; import spatten_tpu_torch.tools.{name}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
