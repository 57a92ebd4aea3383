"""The port's CLI (``run_spatten_gpu.py``) on the CPU against the JAX
package.

``--help`` runs as a subprocess.  A ``--device cpu`` run (in process) on
a tiny randomly initialised Llama checkpoint built with ``transformers``
in ``tmp_path`` (``pytorch_model.bin``, bf16 weights as the CLI loads
them), with a prompts file of one ``ids`` record of two turns over one
rolling pruned state (prunes fire in both turns): each turn's reply ids
equal JAX ``generate`` on the same weights and state sequence (JAX's
loader, the CLI's configuration); the trace CSV's rows equal JAX
``collect_trace`` on the last turn; the summary's fields equal JAX
``collect_run_metrics`` (the wall-clock fields excepted).  Text prompts
without ``transformers`` raise a clear error.

The mesh flags: two gloo ranks under ``python -m torch.distributed.run``
(``--device cpu``) against the JAX CLI's mesh path (its configuration,
``ShardedEngine`` on the CPU mesh, each turn from a fresh state): at
``--mesh_model 2`` rank 0's replies equal JAX's; at ``--mesh_data 2`` both
refuse the CLI's batch of one ("batch must divide the data axis").
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import run_spatten_gpu as cli  # noqa: E402
from spatten_tpu import config as jcfg  # noqa: E402
from spatten_tpu.engine import generate as jgen  # noqa: E402
from spatten_tpu.engine.metrics import collect_run_metrics  # noqa: E402
from spatten_tpu.engine.trace import collect_trace  # noqa: E402
from spatten_tpu.models import hf_loader as jhf  # noqa: E402

from spatten_tpu_torch.engine.trace import read_csv  # noqa: E402

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
EOS, NEW = 2, 24
FLAGS = ["--max_new_tokens", str(NEW), "--start_size", "4",
         "--important_size", "24", "--recent_size", "16",
         "--cache_capacity", "64"]


def test_cli_help():
    out = subprocess.run(
        [sys.executable, str(REPO / "run_spatten_gpu.py"), "--help"],
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0, out.stderr
    for flag in ("--important_size", "--no_pallas", "--device", "ids"):
        assert flag in out.stdout


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, rms_norm_eps=1e-5, rope_theta=10000.0,
        tie_word_embeddings=False, eos_token_id=EOS)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).eval().save_pretrained(
        d / "ckpt", safe_serialization=False)
    rng = np.random.default_rng(0)
    turns = [rng.integers(3, 128, 40).tolist(),
             rng.integers(3, 128, 30).tolist()]
    (d / "prompts.jsonl").write_text(json.dumps({"ids": turns}) + "\n")
    return d, turns


@pytest.fixture(scope="module")
def cli_run(checkpoint):
    d, _ = checkpoint
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--model_path", str(d / "ckpt"), "--prompts",
                  str(d / "prompts.jsonl"), "--trace_csv", str(d / "t.csv"),
                  "--summary", str(d / "s.json"), "--device", "cpu"]
                 + FLAGS)
    text = out.getvalue()
    replies = [json.loads(line.split("reply ids: ", 1)[1])
               for line in text.splitlines()
               if line.startswith("reply ids: ")]
    return text, replies


@pytest.fixture(scope="module")
def jax_run(checkpoint):
    d, turns = checkpoint
    mcfg, params = jhf.load_pretrained(str(d / "ckpt"))
    cfg = jcfg.SpAttenConfig(
        model=mcfg,
        pruning=jcfg.PruningConfig(start_size=4, important_size=24,
                                   recent_size=16, v_keep_ratio=0.35),
        quant=jcfg.QuantConfig(requant_threshold=0.05),
        engine=jcfg.EngineConfig(max_batch_size=1, cache_capacity=64,
                                 prefill_chunk=20),
    ).validate()
    state, replies, result = None, [], None
    for t in turns:
        result = jgen.generate(params, cfg, jnp.asarray([t], jnp.int32),
                               NEW, eos_token_id=EOS, state=state)
        state = result.state
        replies.append([x for x in np.asarray(result.tokens)[0].tolist()
                        if x != EOS])
    ids = jnp.asarray([turns[-1]], jnp.int32)
    rows = collect_trace(params, cfg, ids, 8)
    metrics = collect_run_metrics(cfg, result, len(turns), len(turns[-1]),
                                  1.0)
    return replies, rows, metrics, result


def test_cli_replies_equal_jax_generate(cli_run, jax_run):
    text, replies = cli_run
    want, _, _, result = jax_run
    assert len(replies) == 2 and replies == want
    assert "device: cpu" in text
    # both turns over one rolling state, pruned along the way
    assert int(np.asarray(result.state.lengths)[0]) < 40 + 30 + 2 * NEW


def test_cli_trace_rows_equal_jax(checkpoint, cli_run, jax_run):
    d, _ = checkpoint
    _, rows, _, _ = jax_run
    got = read_csv(str(d / "t.csv"))
    assert len(got) == len(rows) == 8 * 2 * 2    # steps x layers x heads
    for g, w in zip(got, rows):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert gd == pytest.approx(wd), (gd, wd)


def test_cli_summary_equals_jax_metrics(checkpoint, cli_run, jax_run):
    d, _ = checkpoint
    _, _, metrics, _ = jax_run
    got = json.loads((d / "s.json").read_text())
    want = json.loads(json.dumps(metrics.summary()))
    for clock in ("wall_seconds", "tokens_per_s"):
        assert got.pop(clock) > 0
        want.pop(clock)
    assert got == want


def test_cli_text_prompts_without_transformers(monkeypatch, checkpoint,
                                               tmp_path):
    d, _ = checkpoint
    (tmp_path / "p.jsonl").write_text(json.dumps({"prompt": "hello"}))
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(SystemExit, match="ids"):
        cli.main(["--model_path", str(d / "ckpt"), "--prompts",
                  str(tmp_path / "p.jsonl"), "--device", "cpu"] + FLAGS)


def run_mesh_cli(checkpoint, *flags):
    """The CLI on two gloo ranks started by PyTorch's launcher."""
    d, _ = checkpoint
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", str(REPO / "run_spatten_gpu.py"),
           "--model_path", str(d / "ckpt"), "--prompts",
           str(d / "prompts.jsonl"), "--device", "cpu", *flags, *FLAGS]
    return subprocess.run(cmd, capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=str(REPO),
                                   OMP_NUM_THREADS="1"))


def jax_mesh_cfg(mcfg, data, model):
    """The JAX CLI's configuration (``run_spatten_tpu.py``) with a mesh."""
    return jcfg.SpAttenConfig(
        model=mcfg,
        pruning=jcfg.PruningConfig(start_size=4, important_size=24,
                                   recent_size=16, v_keep_ratio=0.35),
        quant=jcfg.QuantConfig(requant_threshold=0.05),
        engine=jcfg.EngineConfig(max_batch_size=1, cache_capacity=64,
                                 prefill_chunk=20,
                                 mesh=jcfg.MeshConfig(data=data,
                                                      model=model)),
    ).validate()


def test_cli_mesh_model_2_replies_equal_jax_mesh_path(checkpoint):
    from spatten_tpu.parallel import ShardedEngine, make_mesh
    d, turns = checkpoint
    out = run_mesh_cli(checkpoint, "--mesh_model", "2")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh 1 x 2" in out.stdout
    got = [json.loads(line.split("reply ids: ", 1)[1])
           for line in out.stdout.splitlines()
           if line.startswith("reply ids: ")]
    mcfg, params = jhf.load_pretrained(str(d / "ckpt"))
    cfg = jax_mesh_cfg(mcfg, 1, 2)
    eng = ShardedEngine(cfg, make_mesh(cfg.engine.mesh))
    sp = eng.shard_params(params)
    want = []
    for t in turns:
        toks = eng.generate(sp, jnp.asarray([t], jnp.int32), NEW,
                            eos_token_id=EOS)
        want.append([x for x in np.asarray(toks)[0].tolist() if x != EOS])
    assert got == want and len(got) == 2     # rank 0 alone prints


def test_cli_mesh_data_2_refuses_batch_one_as_jax_does(checkpoint):
    from spatten_tpu.parallel import ShardedEngine, make_mesh
    d, _ = checkpoint
    out = run_mesh_cli(checkpoint, "--mesh_data", "2")
    assert out.returncode != 0
    assert "batch must divide the data axis" in out.stdout + out.stderr
    mcfg, _ = jhf.load_pretrained(str(d / "ckpt"))
    cfg = jax_mesh_cfg(mcfg, 2, 1)
    with pytest.raises(ValueError, match="batch must divide the data axis"):
        ShardedEngine(cfg, make_mesh(cfg.engine.mesh))
