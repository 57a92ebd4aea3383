"""The port's DP x TP ``ShardedEngine`` (one gloo process per shard) vs
the JAX package's ``ShardedEngine`` on the 8-device CPU mesh of
``tests/conftest.py``, on ``tests/test_sharded.py``'s tiny configuration.

One spawn of four gloo ranks per module runs every mesh in turn: DP 2 x
TP 2, DP only (2 x 1), TP only (1 x 2) and 1 x 1 (ranks past a mesh sit
it out).  Each rank takes its block of the JAX f32 parameters through
``convert.local_params_from_jax``, prefills a 20-token prompt in chunks of
8 and decodes 16 greedy tokens, pruning at capacity 32 along the way, by
the step functions (logits of every step kept) and by ``generate``.  The
JAX engine runs the same schedule (its decode step's closure returning
logits).  Exact: tokens, ``generate``'s tokens on every rank, lengths,
layer lengths, the global requant count and each rank's int8 planes on
live rows against the JAX shard at its mesh position.  Within 1e-4
(f32): logits.  The 1 x 1 mesh's logits are bit-identical to the port's
unsharded ``maybe_prune`` + ``forward`` on the same schedule, and a
``forward`` with ``tp_group=None`` calls no collective.

In bf16, on a model whose 4 kv heads split over TP 4 (``build_bf16``),
both engines run 1 x 4, 2 x 2 and 1 x 1 teacher-forced on the same tokens,
and the port's departure from its own 1-rank run is held to JAX's times
``TP_GAP_FACTOR`` (``test_bf16_tp_gap_within_jax``; the bound the card's
TP and DP runs are held to, ``chip_smoke.against_one_rank``, comes from
JAX's gap measured here).

The ranks import no JAX: this module imports it inside the fixtures.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.parallel import launch

TESTS = Path(__file__).resolve().parent
MESHES = {"dp2 x tp2": (2, 2), "dp2": (2, 1), "tp2": (1, 2), "1x1": (1, 1)}
BATCH, PROMPT_LEN, NEW, CHUNK = 4, 20, 16, 8
TOL = dict(atol=1e-4, rtol=1e-4)
# bf16 runs of both engines, each mesh against its own 1-rank run
BF16_MESHES = {"1x4": (1, 4), "2x2": (2, 2), "1x1": (1, 1)}
# The port's bf16 departure from its 1-rank run may exceed JAX's by this
# factor (measured: 1.00x at 1 x 4, 0.96x at 2 x 2 in mean |logit diff|,
# and a higher argmax agreement): the card runs deeper and wider models,
# and NCCL sums the partials in another order than gloo and XLA.
TP_GAP_FACTOR = 1.5


def build(mod, data, model):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=8, v_keep_ratio=0.5,
                                  v_block_size=4),
        quant=mod.QuantConfig(requant_threshold=0.1),
        engine=mod.EngineConfig(max_batch_size=BATCH, cache_capacity=32,
                                prefill_chunk=CHUNK,
                                mesh=mod.MeshConfig(data=data, model=model)),
    ).validate()


def build_bf16(mod, data, model):
    """A model whose 4 kv heads split over TP 4: 4 layers, 8 query heads
    over 4 kv heads of 16, hidden 128; capacity 32 prunes in the prompt
    and in the decode steps."""
    return mod.SpAttenConfig(
        model=mod.ModelConfig(vocab_size=256, hidden_size=128, num_layers=4,
                              num_heads=8, num_kv_heads=4, head_dim=16,
                              intermediate_size=256,
                              max_position_embeddings=512),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=8, v_keep_ratio=0.5,
                                  v_block_size=4),
        quant=mod.QuantConfig(requant_threshold=0.1),
        engine=mod.EngineConfig(max_batch_size=BATCH, cache_capacity=32,
                                prefill_chunk=CHUNK,
                                mesh=mod.MeshConfig(data=data, model=model)),
    ).validate()


def state_np(st):
    """A DecodeState as a tree of numpy arrays (f32 for bf16)."""
    def a(t):
        if t is None:
            return None
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return type(st)(
        type(st.cache)(*(type(q)(*(a(x) for x in q)) for q in st.cache)),
        *(a(x) for x in st[1:]))


# ---------------------------------------------------------------- ranks
def forced_logits(eng, params, prompt, forced):
    """A teacher-forced run of this rank's rows: the prompt in chunks, then
    the decode steps fed ``forced`` [B, NEW]; the logits of each chunk's
    last position and of each step, f32 [chunks + NEW, B_rank, V]."""
    rows = eng.rows(BATCH)
    local = torch.from_numpy(prompt[rows]).long()
    st = eng.init_sharded_state(BATCH)
    out = []
    for pos in range(0, PROMPT_LEN, CHUNK):
        lg, st = eng.prefill_step()(params, st, local[:, pos:pos + CHUNK])
        out.append(lg)
    for tok in torch.from_numpy(forced[rows]).T:
        lg, st = eng.decode_logits(params, st, tok.to(torch.int32))
        out.append(lg)
    return torch.stack(out).float().numpy()


def sharded_rank(rank, world, params_np, prompt, bf16_np=None, forced=None):
    """Every mesh of MESHES in turn on this rank (no JAX here); then, with
    ``bf16_np``, every mesh of BF16_MESHES teacher-forced on ``forced``."""
    from spatten_tpu_torch.convert import local_params_from_jax
    from spatten_tpu_torch.engine import generate as gen
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.parallel import ShardedEngine, make_mesh
    from spatten_tpu_torch.parallel.sharded import param_pspecs
    out = {}
    for name, (dp, tp) in MESHES.items():
        cfg = build(tcfg, dp, tp)
        mesh = make_mesh(cfg.engine.mesh, device="cpu")
        if mesh.coords is None:
            continue
        eng = ShardedEngine(cfg, mesh)
        params = local_params_from_jax(params_np, param_pspecs(params_np),
                                       mesh, "cpu")
        rows = eng.rows(BATCH)
        local = torch.from_numpy(prompt[rows]).long()
        st = eng.init_sharded_state(BATCH)
        logits, tokens = [], []
        for pos in range(0, PROMPT_LEN, CHUNK):
            lg, st = eng.prefill_step()(params, st, local[:, pos:pos + CHUNK])
            logits.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32)
        for _ in range(NEW):
            tokens.append(tok)
            lg, st = eng.decode_logits(params, st, tok)
            logits.append(lg)
            tok = torch.argmax(lg, -1).to(torch.int32)
        res = dict(coords=dict(mesh.coords), rows=(rows.start, rows.stop),
                   logits=torch.stack(logits).numpy(),
                   tokens=torch.stack(tokens, 1).numpy(),
                   generate=eng.generate(params, prompt, NEW).numpy(),
                   state=state_np(st))
        if name == "1x1":
            # the same schedule through the unsharded port, no group
            ref = init_state(cfg, BATCH, device="cpu")
            steps = [local[:, pos:pos + CHUNK]
                     for pos in range(0, PROMPT_LEN, CHUNK)]
            steps += [torch.from_numpy(t)[:, None] for t in res["tokens"].T]
            plain = []
            for x in steps:
                ref, _ = gen.maybe_prune(cfg, ref, x.shape[1])
                lg, ref, _ = tr.forward(params, cfg, ref, x)
                plain.append(lg[:, -1])
            res["plain_logits"] = torch.stack(plain).numpy()
        out[name] = res
    for name, (dp, tp) in BF16_MESHES.items():
        cfg = build_bf16(tcfg, dp, tp)
        mesh = make_mesh(cfg.engine.mesh, device="cpu")
        if mesh.coords is None:
            continue
        eng = ShardedEngine(cfg, mesh)
        params = local_params_from_jax(bf16_np, param_pspecs(bf16_np), mesh,
                                       "cpu")
        out["bf16 " + name] = dict(
            coords=dict(mesh.coords), rows=eng.rows(BATCH),
            logits=forced_logits(eng, params, prompt, forced))
    try:
        make_mesh(tcfg.MeshConfig(data=1, model=1))
        out["default device"] = None
    except RuntimeError as e:                  # no card on this host
        out["default device"] = str(e)
    real = torch.cuda.is_available, torch.cuda.current_device
    torch.cuda.is_available, torch.cuda.current_device = (lambda: True,
                                                          lambda: 0)
    try:
        out["card default"] = str(make_mesh(
            tcfg.MeshConfig(data=1, model=1)).device)
    finally:
        torch.cuda.is_available, torch.cuda.current_device = real
    try:
        make_mesh(tcfg.MeshConfig(data=4, model=2), device="cpu")
        out["too big"] = None
    except ValueError as e:
        out["too big"] = str(e)
    return out


# ---------------------------------------------------------------- JAX
def run_jax(name, jparams, prompt, forced=None):
    """JAX's engine on mesh ``name`` of MESHES; with ``forced``, on mesh
    ``name`` of BF16_MESHES at ``build_bf16``, its decode steps fed
    ``forced`` [B, NEW] instead of its own greedy tokens."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from spatten_tpu import config as jcfg
    import spatten_tpu.engine.generate as jgen
    from spatten_tpu.models import transformer as jtr
    from spatten_tpu.parallel import ShardedEngine, make_mesh

    if forced is None:
        cfg = build(jcfg, *MESHES[name])
    else:
        cfg = build_bf16(jcfg, *BF16_MESHES[name])
    eng = ShardedEngine(cfg, make_mesh(cfg.engine.mesh))
    lcfg = eng.lcfg

    def decode_logits(params, state, token):     # JAX's _decode, logits out
        state, _ = jgen.maybe_prune(lcfg, state, 1)
        logits, state, aux = jtr.forward(params, lcfg, state, token[:, None],
                                         tp_axis="model")
        global_req = jax.lax.psum(aux.requant_events, ("data", "model"))
        prev = state.requant_events - aux.requant_events
        return logits[:, -1], state._replace(
            requant_events=prev + global_req)

    sp = eng.shard_params(jparams)
    step = eng._shard_mapped(decode_logits, P("data"))
    state = eng.init_sharded_state(BATCH)
    prefill = eng.prefill_step()
    toks = jnp.asarray(prompt)
    logits, tokens = [], []
    for pos in range(0, PROMPT_LEN, CHUNK):
        lg, state = prefill(sp, state, jax.device_put(
            toks[:, pos:pos + CHUNK], eng.named(P("data", None))))
        logits.append(np.asarray(lg))
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for i in range(NEW):
        if forced is not None:
            tok = jax.device_put(jnp.asarray(forced[:, i], jnp.int32),
                                 eng.named(P("data")))
        tokens.append(np.asarray(tok))
        lg, state = step(sp, state, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    if forced is not None:
        return np.stack(logits).astype(np.float32)
    return dict(logits=np.stack(logits), tokens=np.stack(tokens, 1),
                generate=np.asarray(eng.generate(sp, toks, NEW)),
                state=jax.tree.map(np.asarray, state))


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from spatten_tpu import config as jcfg
    from spatten_tpu.models import transformer as jtr

    assert len(jax.devices()) >= 4, "conftest must force 8 CPU devices"
    jc = build(jcfg, 1, 1)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, jparams)
    prompt = np.random.default_rng(3).integers(
        0, jc.model.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    jb = build_bf16(jcfg, 1, 1)
    bf16 = jtr.init_params(jb.model, jax.random.PRNGKey(1),
                           dtype=jnp.bfloat16)
    bf16_np = jax.tree.map(np.asarray, bf16)
    forced = np.random.default_rng(4).integers(
        0, jb.model.vocab_size, (BATCH, NEW)).astype(np.int32)
    ranks = launch.spawn("test_torch_sharded:sharded_rank", 4, params_np,
                         prompt, bf16_np, forced, timeout=300, path=[TESTS])
    want = {name: run_jax(name, jparams, prompt) for name in MESHES}
    want.update({"bf16 " + name: run_jax(name, bf16, prompt, forced)
                 for name in BF16_MESHES})
    return ranks, want


def members(ranks, name):
    return [r[name] for r in ranks if name in r]


def test_shard_slice_cuts_the_rank_block():
    """A spec's axes cut a global tensor into equal blocks by the rank's
    coordinates; replicated dimensions stay whole; an uneven split
    raises."""
    from spatten_tpu_torch.parallel.mesh import Mesh
    from spatten_tpu_torch.parallel.sharded import shard_slice
    t = torch.arange(2 * 4 * 6).reshape(2, 4, 6)
    pos = Mesh(("data", "model"), {"data": 2, "model": 3},
               {"data": 1, "model": 2})
    assert torch.equal(shard_slice(t, (None, "data", "model"), pos),
                       t[:, 2:4, 4:6])
    assert torch.equal(shard_slice(t, (), pos), t)
    with pytest.raises(ValueError, match="does not split"):
        shard_slice(t, ("model",), pos)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_tokens_and_logits_match_jax(runs, name):
    ranks, want = runs
    w = want[name]
    got = members(ranks, name)
    assert len(got) == MESHES[name][0] * MESHES[name][1]
    for r in got:
        rows = slice(*r["rows"])
        np.testing.assert_array_equal(r["tokens"], w["tokens"][rows])
        np.testing.assert_allclose(r["logits"], w["logits"][:, rows], **TOL)
        np.testing.assert_array_equal(r["generate"], w["generate"])
        assert r["generate"].dtype == np.int32


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_state_matches_jax_shard(runs, name):
    """Lengths, layer lengths and the global requant count exact; each
    rank's int8 planes on its live rows equal the JAX shard at its mesh
    position (token-major planes: its batch rows and its heads' lanes),
    cut from the JAX global state by ``convert.local_state_from_jax``."""
    from spatten_tpu_torch.convert import local_state_from_jax
    from spatten_tpu_torch.parallel.mesh import Mesh
    from spatten_tpu_torch.parallel.sharded import state_pspecs
    ranks, want = runs
    ws = want[name]["state"]
    dp, tp = MESHES[name]
    pruned = fired = False
    for r in members(ranks, name):
        st = r["state"]
        pos = Mesh(("data", "model"), {"data": dp, "model": tp},
                   r["coords"])
        js = state_np(local_state_from_jax(ws, state_pspecs(ws), pos, "cpu"))
        assert js.cache.k.full.shape == st.cache.k.full.shape
        np.testing.assert_array_equal(st.lengths, js.lengths)
        np.testing.assert_array_equal(st.layer_lengths, js.layer_lengths)
        np.testing.assert_array_equal(st.head_mask, js.head_mask)
        assert int(st.requant_events) == int(js.requant_events)
        fired |= int(st.requant_events) > 0
        pruned |= bool((st.layer_lengths < PROMPT_LEN + NEW).any())
        for tq, jq in ((st.cache.k, js.cache.k), (st.cache.v, js.cache.v)):
            for l in range(st.layer_lengths.shape[0]):
                for b, n in enumerate(st.layer_lengths[l]):
                    np.testing.assert_array_equal(tq.full[l, b, :n],
                                                  jq.full[l, b, :n])
    assert pruned and fired


def test_make_mesh_refuses_a_world_too_small(runs):
    """As JAX's ``make_mesh``: a 4 x 2 mesh needs 8 processes."""
    ranks, _ = runs
    for r in ranks:
        assert r["too big"] == "mesh 4x2 needs 8 devices, have 4"


def test_make_mesh_defaults_to_the_card(runs):
    """Without ``device``, a mesh lives on the current CUDA device (cuda:0
    with CUDA patched in); on a host without CUDA it raises, so a run on
    the CPU asks for it."""
    ranks, _ = runs
    for r in ranks:
        assert r["card default"] == "cuda:0"
        assert "CUDA is not available" in r["default device"]


def test_one_rank_mesh_is_the_unsharded_port(runs):
    """ShardedEngine on a 1 x 1 mesh (no tensor-parallel group) gives the
    logits of the port's own maybe_prune + forward, bit for bit."""
    ranks, _ = runs
    [r] = members(ranks, "1x1")
    np.testing.assert_array_equal(r["logits"], r["plain_logits"])


def test_forward_without_tp_group_calls_no_collective(monkeypatch):
    """``tp_group=None`` (the default) leaves ``forward`` what it was: no
    collective runs and the logits equal the call without the argument."""
    from spatten_tpu_torch.engine.state import init_state
    from spatten_tpu_torch.models import transformer as tr

    def refuse(*a, **k):
        raise AssertionError("a collective ran")

    monkeypatch.setattr(torch.distributed, "all_reduce", refuse)
    cfg = build(tcfg, 1, 1)
    params = tr.init_params(cfg.model, 0, dtype=torch.float32, device="cpu")
    tokens = torch.arange(6)[None].repeat(2, 1)
    outs = []
    for kw in ({}, dict(tp_group=None, layer_offset=0)):
        st = init_state(cfg, 2, device="cpu")
        lg, st, _ = tr.forward(params, cfg, st, tokens, **kw)
        lg2, _, _ = tr.forward(params, cfg, st, tokens[:, :1], **kw)
        outs.append((lg, lg2))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def gap(got, want):
    """(mean |diff|, argmax agreement, mean |diff| by step) of two logit
    stacks [steps, B, V]."""
    diff = np.abs(got - want)
    return (float(diff.mean()),
            float((got.argmax(-1) == want.argmax(-1)).mean()),
            diff.mean(axis=(1, 2)))


def bf16_gaps(runs, first=0):
    """Each engine's bf16 mesh runs against its own 1-rank run, over the
    steps from ``first``: {mesh: (port's gap, JAX's gap)}, the port's
    logits gathered by rows from its model-rank-0 ranks."""
    ranks, want = runs
    out = {}
    one = members(ranks, "bf16 1x1")[0]["logits"][first:]
    for name in BF16_MESHES:
        if name == "1x1":
            continue
        parts = sorted((r["rows"].start, r["logits"])
                       for r in members(ranks, "bf16 " + name)
                       if r["coords"]["model"] == 0)
        port = np.concatenate([p for _, p in parts], axis=1)[first:]
        out[name] = (gap(port, one),
                     gap(want["bf16 " + name][first:],
                         want["bf16 1x1"][first:]))
    return out


@pytest.mark.parametrize("name", [n for n in BF16_MESHES if n != "1x1"])
def test_bf16_tp_gap_within_jax(runs, name):
    """Tensor parallelism in bf16 changes the GEMMs' shapes and sums the
    o_proj / down_proj partials over the ranks, so a mesh run departs
    from its 1-rank run by bf16 roundings that SpAtten's discrete
    decisions amplify.  JAX's engine does so too: the port's departure
    (mean |logit diff| and argmax agreement against its own 1-rank run,
    fed the same tokens) is held to JAX's times TP_GAP_FACTOR, over every
    step and over the card's step set (the last prompt chunk and the
    decode steps, which ``chip_smoke.against_one_rank`` reads)."""
    ranks, want = runs
    port, jax_ = bf16_gaps(runs)[name]
    last = -(-PROMPT_LEN // CHUNK) - 1
    port_card = bf16_gaps(runs, first=last)[name][0]
    jax_card = bf16_gaps(runs, first=last)[name][1]
    scale = float(np.abs(want["bf16 1x1"]).mean())
    print(f"bf16 {name}: mean |logit| {scale:.4f}; port mean |diff| "
          f"{port[0]:.4f} argmax {port[1]:.4f}; JAX {jax_[0]:.4f} / "
          f"{jax_[1]:.4f}; card steps: port {port_card[0]:.4f} / "
          f"{port_card[1]:.4f}, JAX {jax_card[0]:.4f} / {jax_card[1]:.4f}; "
          f"port by step {np.round(port[2], 4).tolist()}; JAX by step "
          f"{np.round(jax_[2], 4).tolist()}")
    assert jax_[0] > 0 and port[0] > 0       # TP rounds apart in both
    for p, j in ((port, jax_), (port_card, jax_card)):
        assert p[0] <= TP_GAP_FACTOR * j[0], (p, j)
        assert 1.0 - p[1] <= TP_GAP_FACTOR * (1.0 - j[1]), (p, j)
