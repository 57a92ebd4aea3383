"""The port's ``PipelineEngine`` (one gloo process per stage and model
rank) vs the JAX package's ``PipelineEngine`` on the 8-device CPU mesh of
``tests/conftest.py``, on ``tests/test_pipeline.py``'s tiny configuration
(2 layers, so 2 stages of one layer).

One spawn of four gloo ranks per module runs every mesh in turn: PP 2,
PP 2 with 2 microbatches (the GPipe schedule) and PP 2 x TP 2 with 2
microbatches (ranks past a mesh sit it out).  Each rank takes its block
of the JAX f32 parameters through ``convert.local_params_from_jax``,
prefills a 20-token prompt in chunks of 8 and decodes 16 greedy tokens
(prunes at capacity 32 and requants along the way) by ``step_fn``, and
runs ``generate``; the JAX engine runs the same schedule.  Exact: tokens,
``generate``'s tokens, the global requant count, each rank's lengths
against the JAX device's copy at its mesh position (a stage's lengths
follow its own layers after a prune), layer lengths and int8 planes on
live rows against the JAX shard.  Within 1e-4 (f32): logits, on every
rank.  Also: ``init_params`` drawing a rank's shard from a seed equals the
shard of the whole tree from that seed, for both engines.

The ranks import no JAX: this module imports it inside the fixtures.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.parallel import launch

TESTS = Path(__file__).resolve().parent
# name -> (stages, model ranks, microbatches)
MESHES = {"pp2": (2, 1, 1), "pp2 m2": (2, 1, 2), "pp2 x tp2 m2": (2, 2, 2)}
BATCH, PROMPT_LEN, NEW, CHUNK = 2, 20, 16, 8
TOL = dict(atol=1e-4, rtol=1e-4)


def build(mod):
    return mod.SpAttenConfig(
        model=mod.ModelConfig.tiny(),
        pruning=mod.PruningConfig(start_size=2, important_size=8,
                                  recent_size=8, v_keep_ratio=0.5,
                                  v_block_size=4),
        quant=mod.QuantConfig(requant_threshold=0.1),
        engine=mod.EngineConfig(max_batch_size=BATCH, cache_capacity=32,
                                prefill_chunk=CHUNK),
    ).validate()


def state_np(st):
    def a(t):
        return None if t is None else t.detach().cpu().numpy()
    return type(st)(
        type(st.cache)(*(type(q)(*(a(x) for x in q)) for q in st.cache)),
        *(a(x) for x in st[1:]))


def same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k]) for k in a)
    return torch.equal(a, b)


# ---------------------------------------------------------------- ranks
def pipeline_rank(rank, world, params_np, prompt):
    """Every mesh of MESHES in turn on this rank (no JAX here)."""
    from spatten_tpu_torch.config import MeshConfig
    from spatten_tpu_torch.convert import local_params_from_jax
    from spatten_tpu_torch.models import transformer as tr
    from spatten_tpu_torch.parallel import (
        PipelineEngine, ShardedEngine, make_mesh,
    )
    from spatten_tpu_torch.parallel.pipeline import pipeline_param_pspecs
    cfg = build(tcfg)
    out = {}
    for name, (pp, tp, micro) in MESHES.items():
        mesh = make_mesh(MeshConfig(data=pp, model=tp,
                                    axis_names=("pipe", "model")),
                         device="cpu")
        if mesh.coords is None:
            continue
        eng = PipelineEngine(cfg, mesh, microbatches=micro)
        params = local_params_from_jax(
            params_np, pipeline_param_pspecs(params_np, tp=tp > 1), mesh,
            "cpu")
        st = eng.init_sharded_state(BATCH)
        toks = torch.from_numpy(prompt).long()
        logits, tokens = [], []
        for pos in range(0, PROMPT_LEN, CHUNK):
            x = toks[:, pos:pos + CHUNK]
            lg, st = eng.step_fn(x.shape[1])(params, st, x)
            logits.append(lg)
        tok = torch.argmax(lg, -1).to(torch.int32)
        for _ in range(NEW):
            tokens.append(tok)
            lg, st = eng.step_fn(1)(params, st, tok[:, None])
            logits.append(lg)
            tok = torch.argmax(lg, -1).to(torch.int32)
        drawn = eng.init_params(5, dtype=torch.float32)
        whole = eng.shard_params(tr.init_params(cfg.model, 5,
                                                dtype=torch.float32,
                                                device="cpu"))
        out[name] = dict(coords=dict(mesh.coords),
                         logits=torch.stack(logits).numpy(),
                         tokens=torch.stack(tokens, 1).numpy(),
                         generate=eng.generate(params, prompt, NEW).numpy(),
                         state=state_np(st),
                         drawn_is_shard=same_tree(drawn, whole))
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    eng = ShardedEngine(cfg, mesh)
    out["sharded draw"] = same_tree(
        eng.init_params(5, dtype=torch.float32),
        eng.shard_params(tr.init_params(cfg.model, 5, dtype=torch.float32,
                                        device="cpu")))
    return out


# ---------------------------------------------------------------- JAX
def run_jax(name, jparams, prompt):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from spatten_tpu import config as jcfg
    from spatten_tpu.parallel.pipeline import PipelineEngine

    pp, tp, micro = MESHES[name]
    devs = np.asarray(jax.devices()[:pp * tp])
    mesh = (Mesh(devs, ("pipe",)) if tp == 1 else
            Mesh(devs.reshape(pp, tp), ("pipe", "model")))
    eng = PipelineEngine(build(jcfg), mesh, microbatches=micro)
    sp = eng.shard_params(jparams)
    state = eng.init_sharded_state(BATCH)
    toks = jnp.asarray(prompt)
    logits, tokens = [], []
    for pos in range(0, PROMPT_LEN, CHUNK):
        x = toks[:, pos:pos + CHUNK]
        lg, state = eng.step_fn(x.shape[1])(sp, state, x)
        logits.append(np.asarray(lg))
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    for _ in range(NEW):
        tokens.append(np.asarray(tok))
        lg, state = eng.step_fn(1)(sp, state, tok[:, None])
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    # each device's own copy of the replicated lengths, by mesh position
    grid = np.asarray(mesh.devices).reshape(pp, tp)
    copies = {d: np.asarray(s.data) for s in state.lengths.addressable_shards
              for d in [s.device]}
    lengths = {(i, j): copies[grid[i, j]] for i in range(pp)
               for j in range(tp)}
    return dict(logits=np.stack(logits), tokens=np.stack(tokens, 1),
                generate=np.asarray(eng.generate(sp, toks, NEW)),
                state=jax.tree.map(np.asarray, state), lengths=lengths)


@pytest.fixture(scope="module")
def runs():
    import jax
    import jax.numpy as jnp

    from spatten_tpu import config as jcfg
    from spatten_tpu.models import transformer as jtr

    assert len(jax.devices()) >= 4, "conftest must force 8 CPU devices"
    jc = build(jcfg)
    jparams = jtr.init_params(jc.model, jax.random.PRNGKey(0),
                              dtype=jnp.float32)
    params_np = jax.tree.map(np.asarray, jparams)
    prompt = np.random.default_rng(4).integers(
        0, jc.model.vocab_size, (BATCH, PROMPT_LEN)).astype(np.int32)
    ranks = launch.spawn("test_torch_pipeline:pipeline_rank", 4, params_np,
                         prompt, timeout=300, path=[TESTS])
    want = {name: run_jax(name, jparams, prompt) for name in MESHES}
    return ranks, want


def members(ranks, name):
    return [r[name] for r in ranks if name in r]


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_tokens_and_logits_match_jax(runs, name):
    ranks, want = runs
    w = want[name]
    got = members(ranks, name)
    assert len(got) == MESHES[name][0] * MESHES[name][1]
    for r in got:
        np.testing.assert_array_equal(r["tokens"], w["tokens"])
        np.testing.assert_allclose(r["logits"], w["logits"], **TOL)
        np.testing.assert_array_equal(r["generate"], w["generate"])


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_state_matches_jax_shard(runs, name):
    """Each rank's stage of layers (and model rank's lanes): lengths
    against the JAX device's own copy, layer lengths, the global requant
    count and the int8 planes on live rows exact."""
    ranks, want = runs
    ws = want[name]["state"]
    pruned = fired = False
    for r in members(ranks, name):
        st, c = r["state"], r["coords"]
        nl, lanes = st.layer_lengths.shape[0], st.cache.k.full.shape[-1]
        layers = slice(c["pipe"] * nl, (c["pipe"] + 1) * nl)
        lo = c["model"] * lanes
        np.testing.assert_array_equal(
            st.lengths, want[name]["lengths"][(c["pipe"], c["model"])])
        np.testing.assert_array_equal(st.layer_lengths,
                                      ws.layer_lengths[layers])
        assert int(st.requant_events) == int(ws.requant_events)
        fired |= int(st.requant_events) > 0
        pruned |= bool((st.layer_lengths < PROMPT_LEN + NEW).any())
        for tq, jq in ((st.cache.k, ws.cache.k), (st.cache.v, ws.cache.v)):
            jfull = jq.full[layers, :, :, lo:lo + lanes]
            for l in range(nl):
                for b, n in enumerate(st.layer_lengths[l]):
                    np.testing.assert_array_equal(tq.full[l, b, :n],
                                                  jfull[l, b, :n])
    assert pruned and fired


def test_init_params_draws_the_shard_of_the_seeded_tree(runs):
    ranks, _ = runs
    for r in ranks:
        assert r["sharded draw"]
        for name in MESHES:
            if name in r:
                assert r[name]["drawn_is_shard"], name


def test_stage_configs_read_an_l_over_p_layer_model():
    """The reference quirk the port keeps (ROADMAP): every stage's local
    configuration is an L/P-layer model, so a stage's per-layer cascade
    budgets and capacity rungs are those of layers 0..L/P-1 of the ratio
    list, not of its own global layers; the layer bits are cut from the
    global model's.  Port and JAX agree on every stage's."""
    from spatten_tpu import config as jcfg
    from spatten_tpu.parallel.pipeline import (
        pipeline_local_config as j_local,
    )
    from spatten_tpu.pruning import token_pruning as jtp

    from spatten_tpu_torch.parallel.pipeline import pipeline_local_config
    from spatten_tpu_torch.pruning import token_pruning as ttp

    def cfg(mod):
        return mod.SpAttenConfig(
            model=dataclasses.replace(mod.ModelConfig(), num_layers=8),
            pruning=mod.PruningConfig(
                start_size=4, important_size=2252, recent_size=409,
                cascade_layer_ratios=(1.0, 0.78, 0.25, 0.25, 0.25, 0.14,
                                      0.14, 0.14), v_block_size=64),
            engine=mod.EngineConfig(cache_capacity=4096)).validate()

    tc, jc = cfg(tcfg), cfg(jcfg)
    whole = ttp.layer_budgets_static(tc.pruning, 8)
    tl, jl = pipeline_local_config(tc, 2), j_local(jc, 2)
    stage = ttp.layer_budgets_static(tl.pruning, tl.model.num_layers)
    assert stage == jtp.layer_budgets_static(jl.pruning, 4)
    assert stage == whole[:4] and stage != whole[4:]
    assert ttp.layer_capacities(tl) == jtp.layer_capacities(jl)
    assert ttp.layer_capacities(tl) != ttp.layer_capacities(tc)[4:]
