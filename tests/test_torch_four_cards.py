"""``chip_smoke.py --cards 4`` rehearsed on the CPU.

The four-card phases (``ShardedEngine`` at 1 x 4 and 2 x 2, Llama-2-70B's
shard over TP 4 with its depth-8 link to a 1-rank run, ``PipelineEngine``
at 4 stages and 2 stages x TP 2) run here through the same phase
functions and ``chip_smoke.mesh_rank`` as on the cards, over 4 gloo ranks
with ``device="cpu"``, each spec cut to a toy size (``toy``: head_dim 16,
4 layers, capacity 128, a 100-token prompt).  Each phase's own checks
hold: replicated tensors equal bit for bit on every rank, the first
decode window against the plain versions, finite logits, the pipeline
stages equal to their 1-rank runs and the TP runs within the bound that
``against_one_rank`` takes from JAX's measured gap.

Besides: the rank -> device mapping (cuda:r under NCCL, cuda:0 under
gloo; ``torch.cuda`` patched), a kernel launch under its tensors' card
and that card's stream (``kernels.launch``, ``torch.cuda`` patched),
``--cards 4`` refusing to start with fewer than 4 cards, and the one-card
run's phase list as it was.
"""

import ast
import contextlib
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")

# the phase's configuration -> the toy model's (layers, kv heads, group,
# base settings): the shard shapes of the cards' runs (1 kv head a rank
# at 7B's TP 4, 2 kv heads of a group at 70B's)
TOY_MODELS = {"serving": (4, 4, 1, "serving"), "70b": (4, 8, 4, "serving"),
              "pipeline": (4, 4, 1, "pipeline")}


def toy(spec):
    layers, kv, group, base = TOY_MODELS[spec["config"]]
    return dict(spec, config="toy",
                config_args=(layers, kv, group, spec["batch"], base),
                prompt_len=100, timeout=300)


def test_sharded_phase_on_four_gloo_ranks():
    out = cs.phase_cards_sharded(CPU, 4, backend="gloo", device="cpu",
                                 shrink=toy)
    for mesh in ("1x4", "2x2"):
        r = out[mesh]
        assert r["ranks"] == 4 and r["replicated_mismatch"] == 0.0
        assert r["vs_one_rank"]["mean_err"] <= cs.TP_MEAN_MAX
        assert r["vs_one_rank"]["argmax"] >= cs.TP_ARGMAX_MIN
        assert {row["device"] for row in r["per_rank"]} == {"cpu"}


def test_70b_phase_on_four_gloo_ranks():
    out = cs.phase_cards_70b(CPU, 4, backend="gloo", device="cpu",
                             shrink=toy)
    assert out["80 layers"]["ranks"] == 4
    assert out["80 layers"]["replicated_mismatch"] == 0.0
    assert out["depth 8"]["vs_one_rank"]["mean_err"] <= cs.TP_MEAN_MAX


def test_pipeline_phase_on_four_gloo_ranks():
    out = cs.phase_pipeline(CPU, backend="gloo", device="cpu", shrink=toy)
    assert [v["exact"] and v["mean_err"] == 0.0
            for v in out["pp4"]["vs_one_rank"]] == [True, True]
    assert not out["pp2_tp2"]["vs_one_rank"]["exact"]
    assert out["pp2_tp2"]["replicated_mismatch"] == 0.0


@pytest.mark.parametrize("backend, want", [
    ("nccl", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    ("gloo", ["cuda:0"] * 4)])
def test_rank_device_mapping(monkeypatch, backend, want):
    """Under NCCL rank r runs on cuda:r, one card a rank; under gloo every
    rank shares cuda:0; a CPU spec stays on the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    spec = dict(device="cuda", backend=backend)
    assert [str(cs.mesh_device(spec, r)) for r in range(4)] == want
    assert cs.mesh_device(dict(spec, device="cpu"), 3) == CPU


class _Stream:
    def __init__(self, dev):
        self.cuda_stream = 1000 + dev.index


def test_launch_takes_its_tensors_card_and_stream(monkeypatch):
    """``kernels.launch`` runs the C entry under the card its tensors lie
    on (``torch.cuda.device``) with that card's current stream, whatever
    the current device is; tensors on two cards raise, as do CPU ones."""
    from spatten_tpu_torch import kernels
    a, b = torch.zeros(4), torch.zeros(2, dtype=torch.int32)
    where = {id(a): torch.device("cuda", 2), id(b): torch.device("cuda", 2)}
    monkeypatch.setattr(torch.Tensor, "device", property(
        lambda t: where.get(id(t), CPU)))
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: 7 + id(t) % 97)
    entered, calls = [], []

    @contextlib.contextmanager
    def guard(dev):
        entered.append(torch.device(dev))
        yield

    monkeypatch.setattr(torch.cuda, "device", guard)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream(torch.device(dev)))
    monkeypatch.setattr(kernels, "entry", lambda name: (
        lambda *args: calls.append(args) or 0))
    kernels.launch("compact_gather", a, b, None, 3)
    assert entered == [torch.device("cuda", 2)]
    assert calls == [(a.data_ptr(), b.data_ptr(), None, 3, 1002)]
    where[id(b)] = torch.device("cuda", 1)
    with pytest.raises(ValueError, match="one device expected"):
        kernels.launch("compact_gather", a, b)
    with pytest.raises(ValueError, match="not a card"):
        kernels.launch("compact_gather", torch.zeros(1))
    assert len(calls) == 1


def test_cards_refuses_fewer_cards(monkeypatch, capsys):
    """``--cards 4`` exits non-zero, printing no result, where fewer than
    4 cards are visible (or none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert cs.main(["--cards", "4"]) != 0
    out = capsys.readouterr()
    assert "2 card(s) visible" in out.err and '"ok"' not in out.out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cs.main(["--cards", "4"]) != 0
    assert cs.main([]) != 0
    assert '"ok"' not in capsys.readouterr().out


# the one-card run's phases, in order, as `python3 chip_smoke.py` runs them
ONE_CARD_PHASES = [
    "phase_k1_slice1", "phase_k1_serving", "phase_k1_llama32",
    "phase_k1_flags", "phase_k1_groups", "phase_k1_head_dims",
    "phase_k1_capacity", "phase_k1_device_scores", "phase_k1_wide_groups",
    "phase_k1_long_windows", "phase_k1_wide_head_dims",
    "phase_k1_shard_shapes", "phase_k1_rounding", "phase_k2", "phase_k2",
    "phase_split_k",
    "phase_launch_probe", "small_reference_check", "phase_gate",
    "server_small_check", "mesh_small_check",
    "run_path:first slice (depth 8)", "run_path:serving",
    "run_path:dense (depth 8)", "run_path:profile 4,4,6,6,8 (depth 8)",
    "run_path:parity (depth 8)", "run_path:Llama-3.2-3B",
    "run_path:OpenLLaMA-3B", "phase_70b_depth", "phase_server",
    "phase_trace", "phase_replay", "phase_supervised", "phase_cli",
    "phase_debug_hook", "phase_ppl", "phase_hbm", "phase_sharded",
    "phase_sharded_70b", "phase_pipeline"]


def test_one_card_run_keeps_its_phases():
    """``main`` (no ``--cards``, through ``run_one_card``) times the same
    phases in the same order, each on one card as before (no backend or
    device list passed)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "run_one_card")
    phases = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", None)
                == "timed"):
            fn = node.args[0].id
            if fn == "run_path":
                fn += ":" + node.args[1].value
            phases.append((node.lineno, fn, node.keywords))
    phases.sort(key=lambda x: x[0])
    assert [fn for _, fn, _ in phases] == ONE_CARD_PHASES
    assert not any(k.arg in ("backend", "devices") for _, _, kws in phases
                   for k in kws)
