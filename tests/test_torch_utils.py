"""The port's debug, profiling, logging and multi-process utilities on the
CPU (``spatten_tpu_torch.utils``, ``spatten_tpu_torch.parallel.multihost``),
against the JAX package where it has the same hook.

* ``checkify_step`` passes a clean forward step and traps NaN weights
  ("nan" in the message, as ``tests/test_debug_hooks.py`` expects of
  JAX) and a division by zero; ``debug_mode`` names the op that made a
  NaN.
* ``SPATTEN_DEBUG=1`` wires ``generate``: its tokens equal the same run
  without the flag and JAX's ``generate`` under the flag (f32 weights,
  the tiny configuration of ``tests/test_debug_hooks.py`` with a prompt
  that prunes in prefill).
* ``replicated_mismatch`` over equal and diverging copies.
* ``profile_trace`` writes a Chrome trace of a CPU forward step.
* ``health_check`` with no process group, and over a two-process gloo
  group (two spawned workers, each joined with its own timeout).
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu import config as jcfg
from spatten_tpu.engine import generate as jgen
from spatten_tpu.models import transformer as jtr

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.convert import params_from_jax
from spatten_tpu_torch.engine import generate as tgen
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer as ttr
from spatten_tpu_torch.parallel import multihost
from spatten_tpu_torch.utils import annotate, get_logger, profile_trace
from spatten_tpu_torch.utils import debug as dbg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def build(mod):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=16, v_block_size=8),
        quant=mod.QuantConfig(enabled=True, enable_requant=True,
                              requant_threshold=0.2),
        engine=mod.EngineConfig(max_batch_size=1, cache_capacity=32,
                                prefill_chunk=6),
    ).validate()


@pytest.fixture(scope="module")
def tiny():
    jc, tc = build(jcfg), build(tcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jc, tc, jparams, tparams


def test_checkify_clean_step_passes(tiny):
    _, tc, _, tparams = tiny
    state = init_state(tc, 1, device="cpu")
    tokens = torch.arange(6)[None] % 256
    logits, state2, _ = dbg.checkify_step(ttr.forward, tparams, tc, state,
                                          tokens)
    assert torch.isfinite(logits).all()
    assert int(state2.lengths[0]) == 6


def test_checkify_traps_nan_weights(tiny):
    _, tc, _, tparams = tiny
    bad = dict(tparams, embed=torch.full_like(tparams["embed"], np.nan))
    tokens = torch.arange(4)[None] % 256
    with pytest.raises(FloatingPointError, match="nan"):
        dbg.checkify_step(ttr.forward, bad, tc, init_state(tc, 1, "cpu"),
                          tokens)


def test_checkify_traps_division_by_zero_and_debug_mode_names_the_op():
    x = torch.ones(4)
    with pytest.raises(FloatingPointError, match="division by zero"):
        dbg.checkify_step(torch.div, x, torch.tensor([1.0, 0.0, 2.0, 3.0]))
    assert torch.equal(dbg.checkify_step(torch.div, x, 2 * x), x / 2)
    with dbg.debug_mode():
        torch.sqrt(x)
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(-x)
    assert torch.isnan(torch.log(-x)).all()        # the mode has ended
    with dbg.debug_mode(nans=False):
        torch.log(-x)


def test_debug_env_flag_wires_generate(monkeypatch, tiny):
    jc, tc, jparams, tparams = tiny
    prompt = np.random.default_rng(0).integers(0, 256, (1, 30))
    plain = tgen.generate(tparams, tc, prompt, 8, device="cpu")
    monkeypatch.setenv("SPATTEN_DEBUG", "1")
    assert dbg.enabled()
    calls = []
    real = dbg.checkify_step

    def spy(fn, *args, **kwargs):
        calls.append(args[1].shape)
        return real(fn, *args, **kwargs)
    monkeypatch.setattr(dbg, "checkify_step", spy)
    got = tgen.generate(tparams, tc, prompt, 8, device="cpu")
    assert calls == [(1, 6)]                  # the first chunk, once
    assert got.pruned_layers == plain.pruned_layers and got.pruned_layers
    torch.testing.assert_close(got.tokens, plain.tokens, rtol=0, atol=0)
    want = jgen.generate(jparams, jc, jnp.asarray(prompt, jnp.int32), 8)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    np.testing.assert_array_equal(got.state.layer_lengths.numpy(),
                                  np.asarray(want.state.layer_lengths))


def test_replicated_mismatch():
    x = torch.arange(8.0)
    assert dbg.replicated_mismatch([x]) == 0.0
    assert dbg.replicated_mismatch([x, x.clone(), x.clone()]) == 0.0
    y = x.clone()
    y[3] += 0.5
    assert dbg.replicated_mismatch([x, x.clone(), y]) == 0.5
    assert dbg.replicated_mismatch(
        [torch.ones(2, dtype=torch.bfloat16), torch.ones(2)]) == 0.0
    with pytest.raises(ValueError, match="not replicas"):
        dbg.replicated_mismatch([x, x[:4]])


def test_profile_trace_writes_a_chrome_trace(tmp_path, tiny):
    _, tc, _, tparams = tiny
    with profile_trace(None) as prof:
        assert prof is None
    with profile_trace(str(tmp_path / "trace")) as prof:
        with annotate("prefill-chunk"):
            ttr.forward(tparams, tc, init_state(tc, 1, "cpu"),
                        torch.arange(6)[None])
    [f] = list((tmp_path / "trace").glob("trace-*.json"))
    events = json.loads(f.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "prefill-chunk" in names and len(events) > 10
    assert any(ev.key == "prefill-chunk" for ev in prof.key_averages())
    assert get_logger().name == "spatten_tpu_torch"
    assert get_logger("x").handlers and get_logger("x") is get_logger("x")


def test_health_check_without_a_group():
    assert not torch.distributed.is_initialized()
    assert multihost.health_check(timeout_s=30.0) is True


WORKER = """
import sys
import torch
from spatten_tpu_torch.parallel import multihost
port, pid = sys.argv[1], int(sys.argv[2])
multihost.initialize(f"tcp://127.0.0.1:{port}", 2, pid)
multihost.initialize(f"tcp://127.0.0.1:{port}", 2, pid)   # a no-op
ok = multihost.health_check(timeout_s=60.0)
print("HEALTH", pid, torch.distributed.get_backend(), ok, flush=True)
torch.distributed.destroy_process_group()
"""


def test_health_check_over_two_gloo_processes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("SPATTEN_DEBUG", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        assert f"HEALTH {pid} gloo True" in out, out
