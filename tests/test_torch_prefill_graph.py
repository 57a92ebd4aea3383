"""The server's prefill graph (``spatten_tpu_torch.engine.prefill_graph``)
on the CPU.

The CPU has no CUDA graph, so the rule that engages it is held case by
case, the staging copies as a round trip over every field, and the
runner's path (the copies, the replay, the outputs it hands back) with a
stand-in for the captured graph whose replay runs the same forward
eagerly on the staging state: a chunk, two admissions interleaved
through the one staging state, and chunks after a prune, each equal to
the eager path.  ``tests/test_torch_cuda.py`` holds the captured graph
against the eager chunk bit for bit on the card.
"""

import numpy as np
import pytest
import torch

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.engine import generate as gen
from spatten_tpu_torch.engine import prefill_graph as pg
from spatten_tpu_torch.engine.server import SpAttenServer
from spatten_tpu_torch.engine.state import init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.pruning import token_pruning
from spatten_tpu_torch.utils.profiling import tracer

torch.set_num_threads(1)

CHUNK = 8


def cfg_of(batch=1, chunk=CHUNK, layer_bits=None, quant=True):
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig.tiny(),
        pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                   recent_size=8, v_keep_ratio=0.5,
                                   v_block_size=4),
        quant=tcfg.QuantConfig(enabled=quant, requant_threshold=0.1,
                               layer_bits=layer_bits),
        engine=tcfg.EngineConfig(max_batch_size=batch, cache_capacity=32,
                                 prefill_chunk=chunk),
    ).validate()


def params(seed=4):
    return transformer.init_params(cfg_of().model, seed,
                                   dtype=torch.float32, device="cpu")


# ------------------------------------------------------------- the rule
ENGAGE_CASES = {
    "card, full chunk": ("cuda", cfg_of(), (1, CHUNK), True),
    "cpu": ("cpu", cfg_of(), (1, CHUNK), False),
    "ragged last chunk": ("cuda", cfg_of(), (1, CHUNK - 3), False),
    "one-token chunk (K1)": ("cuda", cfg_of(chunk=1), (1, 1), False),
    "layer_bits set": ("cuda", cfg_of(layer_bits=(4, 8)), (1, CHUNK),
                       False),
    "layer_bits, quantization off": (
        "cuda", cfg_of(layer_bits=(4, 8), quant=False), (1, CHUNK), True),
    "batch 2": ("cuda", cfg_of(batch=2), (2, CHUNK), False),
}


@pytest.mark.parametrize("case", list(ENGAGE_CASES))
def test_engage_rule(case):
    device_type, cfg, shape, want = ENGAGE_CASES[case]
    assert pg.engages(cfg, device_type, shape) is want


def test_prefill_chunk_on_the_cpu_runs_eagerly():
    """Given a runner, a full chunk on the CPU still runs eagerly: the
    runner makes no staging state and counts no replay."""
    cfg, p = cfg_of(), params()
    runner = pg.PrefillGraph(p, cfg)
    ids = torch.arange(CHUNK, dtype=torch.int32)[None]
    want = gen.prefill_chunk(p, cfg, init_state(cfg, 1, device="cpu"), ids)
    got = gen.prefill_chunk(p, cfg, init_state(cfg, 1, device="cpu"), ids,
                            graph=runner)
    assert torch.equal(got[0], want[0])
    assert runner.staging is None and runner.replays == 0


# ---------------------------------------------------- the staging copies
def fields(state):
    """Every tensor of a state by name (None planes left out)."""
    out = {f"k.{n}": x for n, x in state.cache.k._asdict().items()
           if x is not None}
    out.update({f"v.{n}": x for n, x in state.cache.v._asdict().items()
                if x is not None})
    out.update({n: getattr(state, n) for n in state._fields
                if n != "cache"})
    return out


def randomized(state, seed):
    g = torch.Generator().manual_seed(seed)
    for x in fields(state).values():
        if x.dtype == torch.bool:
            x.copy_(torch.rand(x.shape, generator=g) < 0.5)
        elif x.is_floating_point():
            x.copy_(torch.randn(x.shape, generator=g))
        else:
            x.copy_(torch.randint(0, 100, x.shape, generator=g))
    return state


PLANES = ("k.full", "k.msb", "k.scale", "k.lsb2", "v.full", "v.scale",
          "importance")


@pytest.mark.parametrize("cfg", [cfg_of(layer_bits=(6, 4)),
                                 cfg_of(quant=False)],
                         ids=["6-bit planes", "quantization off"])
def test_staging_round_trip(cfg):
    """``load`` copies every field into the staging state's own tensors;
    ``store`` copies back the planes and importance and nothing else."""
    sub = randomized(init_state(cfg, 1, device="cpu"), 1)
    staging = init_state(cfg, 1, device="cpu")
    pg.load(staging, sub)
    got, want = fields(staging), fields(sub)
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
        assert got[name].data_ptr() != want[name].data_ptr(), name

    randomized(staging, 2)
    back = randomized(init_state(cfg, 1, device="cpu"), 3)
    before = {n: x.clone() for n, x in fields(back).items()}
    pg.store(back, staging)
    for name, x in fields(back).items():
        ref = fields(staging)[name] if name in PLANES else before[name]
        assert torch.equal(x, ref), name


# ---------------------------------------- the runner, with a stand-in graph
class EagerReplay:
    """Stands in for the captured graph on the CPU: a replay runs the
    runner's forward eagerly and writes its outputs into the tensors the
    capture returned, as a graph replay rewrites them."""

    def __init__(self, runner):
        self.runner = runner

    def replay(self):
        for dst, src in zip(self.runner.out, self.runner.forward()):
            dst.copy_(src)


def capture_on_cpu(runner, tokens):
    runner.staging = init_state(runner.cfg, 1, device=tokens.device)
    runner.ids = torch.zeros_like(tokens)
    runner.out = runner.forward()
    runner.graph = EagerReplay(runner)


@pytest.fixture
def on_cpu(monkeypatch):
    """The runner engages on the CPU, with ``EagerReplay`` for its
    graph."""
    engages = pg.engages
    monkeypatch.setattr(pg, "engages",
                        lambda cfg, dt, shape: engages(cfg, "cuda", shape))
    monkeypatch.setattr(pg.PrefillGraph, "capture", capture_on_cpu)


def prompt(n, seed):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 250, (1, n)).astype(
            np.int32))


def assert_states_equal(a, b):
    fa, fb = fields(a), fields(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        assert torch.equal(fa[name], fb[name]), name


def test_graphed_chunks_equal_eager(on_cpu):
    """Three chunks through the runner (the first captures) equal the
    eager chunks on every field, the last logits and the aux; each call
    returns new length tensors and leaves its input's lengths as they
    were (the harness reads the input's ``layer_lengths`` later)."""
    cfg, p = cfg_of(), params()
    runner = pg.PrefillGraph(p, cfg)
    ids = prompt(3 * CHUNK, 0)
    eager = init_state(cfg, 1, device="cpu")
    graphed = init_state(cfg, 1, device="cpu")
    kept = []
    for i in range(3):
        chunk = ids[:, i * CHUNK:(i + 1) * CHUNK]
        want = gen.prefill_chunk(p, cfg, eager, chunk)
        before = graphed.layer_lengths.clone()
        got = gen.prefill_chunk(p, cfg, graphed, chunk, graph=runner)
        assert torch.equal(graphed.layer_lengths, before)
        eager, out = want[1], got[1]
        assert torch.equal(got[0], want[0])
        for x, y in zip(got[2], want[2]):
            # expert counts: None on both sides for a model without experts
            assert (x is None and y is None) or torch.equal(x, y)
        assert_states_equal(out, eager)
        owned = [runner.staging.lengths, runner.staging.layer_lengths,
                 graphed.lengths, graphed.layer_lengths] + list(runner.out)
        for x in (out.lengths, out.layer_lengths, out.requant_events,
                  got[0]):
            assert all(x.data_ptr() != y.data_ptr() for y in owned)
        kept.append((out.lengths, out.lengths.clone()))
        graphed = out
    # a later replay leaves what an earlier call returned as it was
    for x, copy in kept:
        assert torch.equal(x, copy)
    assert runner.replays == 3


def serve(p, cfg, requests, graph: bool):
    """Every request's tokens, and the runner's replays, from a traced
    server run; ``graph`` False takes the runner away (eager chunks)."""
    srv = SpAttenServer(p, cfg, device="cpu")
    if not graph:
        srv.prefill_graph = None
    for ids, new in requests:
        srv.submit(ids, new)
    tracer.drain()
    tracer.enable()
    try:
        done = srv.run_to_completion()
    finally:
        tracer.disable()
    spans = tracer.drain()
    tokens = {r.request_id: r.generated for r in done}
    return tokens, srv.prefill_graph, spans


def test_admissions_interleave_through_one_staging_state(on_cpu):
    """Two slots admit prompts of several chunks at once (their chunks
    alternate through the one staging state) and later ones past the
    capacity (a prune before a chunk); every token equals the eager
    server's, every full chunk replays, each in one
    ``engine.prefill_replay`` span, and the capture happens once."""
    cfg, p = cfg_of(batch=2), params()
    lengths = (3 * CHUNK, 2 * CHUNK + 5, 4 * CHUNK + 1, 5 * CHUNK)
    requests = [(prompt(n, i)[0].numpy(), 5) for i, n in enumerate(lengths)]
    want, _, _ = serve(p, cfg, requests, graph=False)
    got, runner, spans = serve(p, cfg, requests, graph=True)
    assert got == want
    names = [s.name for s in spans]
    full = sum(n // CHUNK for n in lengths)
    assert runner.replays == full
    assert names.count("engine.prefill_replay") == full
    assert names.count("engine.prefill_capture") == 1
    assert names.count("engine.prefill") == sum(-(-n // CHUNK)
                                                for n in lengths)
    assert any(s.name == "engine.prune" and s.attrs.get("layers")
               for s in spans)
    for s in spans:
        if s.name in ("engine.prefill_replay", "engine.prefill_capture"):
            assert spans[s.parent].name == "engine.prefill"


def test_chunk_after_a_prune_equals_eager(on_cpu):
    """A prompt past the capacity: the prune before each late chunk runs
    eagerly on the admission's own state, then the chunk replays; the
    state equals the eager path's."""
    cfg, p = cfg_of(), params()
    ids = prompt(6 * CHUNK, 7)
    runner = pg.PrefillGraph(p, cfg)
    eager = init_state(cfg, 1, device="cpu")
    graphed = init_state(cfg, 1, device="cpu")
    caps = torch.tensor(token_pruning.layer_capacities(cfg))
    pruned = 0
    for i in range(6):
        chunk = ids[:, i * CHUNK:(i + 1) * CHUNK]
        pruned += int(bool((eager.layer_lengths[:, 0] + CHUNK > caps).any()))
        want = gen.prefill_chunk(p, cfg, eager, chunk)
        got = gen.prefill_chunk(p, cfg, graphed, chunk, graph=runner)
        assert torch.equal(got[0], want[0])
        eager, graphed = want[1], got[1]
        assert_states_equal(graphed, eager)
    assert pruned >= 1 and runner.replays == 6
