"""K1 at GQA groups past 8, at head dims past 256 lanes and at long
windows, in the port vs the JAX package, on the CPU.

K1's plain version against JAX ``fused_decode_attention(interpret=True)``
on the same numpy inputs under the serving flags (int8 queries, integer
P·V, the bf16 probability plane, bf16 scales and importance, requant, V
pruning, a partly head-masked group) at Llama-3.1-405B's group (16 query
heads over 1 kv head of 128) and at group 12 (24 over 2 kv heads of 64,
a 6-bit layer), which the CUDA kernel runs in its ``<8, D>`` instance as
chunks of 8 rows.  Tolerances, as ``tests/test_torch_k1_groups.py``:
planes after the append exact, need_requant exact (the threshold sits
clear of every max prob), out and max prob within 2e-5 / 1e-4,
importance one bf16 step, the per-row probability deltas of a second
call in delta mode within 2e-5 / 1e-4 and the kept V blocks derived from
them by the kernel's counting rule exact.

The same comparison at head dims past 256 lanes, which the CUDA kernel
runs in its ``<G, 256>`` instances as lane pieces (``lane_pieces``):
head_dim 288 over 4 kv heads (group 4), 384 over 2 (group 2, a 6-bit
layer), 512 over 1 (group 8) and 1024 over 1 (MHA), at the same
tolerances (integer P·V where the row count tiles by 8, as the Pallas
kernel in interpret mode applies it only there).

Then the wrapper's limits against the JAX kernel's fit rule
(``_heads_per_program``): every (kv heads 1-32, group, head_dim up to
4096 lanes, capacity 1024-131072, v_block) the JAX kernel takes, K1
takes (``k1_shape_error`` is None); the wrapper's card branch
(``is_cuda`` patched, the launch recorded) passes a group-16 launch the
<8, 128> instance, the live group and a [B, Hkv, 16, C] score plane, a
long window (1 kv head of group 8 at 65,536 tokens, v_block 16) a device
block plane, and head dims 320 and 1024 the <G, 256> instance with the
live head_dim.  Last, the device-plane instances' bit search for a row's
k-th largest V-block mass keeps the blocks the counting rule keeps.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatten_tpu.ops import fused_decode as jfd
from spatten_tpu.ops import quantize as jqz

from spatten_tpu_torch import config as tcfg
from spatten_tpu_torch.kernel_checks import random_state
from spatten_tpu_torch.ops import fused_decode as tfd
from spatten_tpu_torch.ops import quantize as tqz

torch.set_num_threads(1)

T = torch.from_numpy
LAYER, CAP, VB, V_KEEP = 1, 64, 8, (24, 16)
LENGTHS = np.array([50, 31], np.int32)
TOL = dict(atol=2e-5, rtol=1e-4)

# name -> (query heads, kv heads, head_dim, 6-bit layer); both row counts
# tile by 8, so the Pallas kernel in interpret mode runs integer P·V
SHAPES = {
    "G16 16/1 x 128": (16, 1, 128, False),
    "G12 24/2 x 64 6-bit": (24, 2, 64, True),
}
# head dims past 256 lanes, which K1 runs in <G, 256> as lane pieces
WIDE_SHAPES = {
    "288 G4 16/4": (16, 4, 288, False),
    "384 G2 4/2 6-bit": (4, 2, 384, True),
    "512 G8 8/1": (8, 1, 512, False),
    "1024 MHA 1/1": (1, 1, 1024, False),
}


def shape_of(name):
    return SHAPES[name] if name in SHAPES else WIDE_SHAPES[name]


def seed_of(name):
    if name in SHAPES:
        return 90 + sorted(SHAPES).index(name)
    return 190 + sorted(WIDE_SHAPES).index(name)


def f32np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def head_mask(hq: int, hkv: int) -> np.ndarray:
    """Every group alive but the last, whose first row is dead (a single
    row stays alive)."""
    hm = np.ones((hkv, hq // hkv), bool)
    if hm.size > 1:
        hm[-1, 0] = False
    return hm.reshape(hq)


def inputs(name):
    hq, hkv, d, six = shape_of(name)
    rng = np.random.default_rng(seed_of(name))
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
    hq, _, _, six = shape_of(name)
    return dict(sm_scale=0.25, v_block_size=VB, v_keep=V_KEEP,
                requant_threshold=threshold, quantize_queries=True,
                probs_bf16=True, pv_int8=hq % 8 == 0,
                quant_bits=(4, 6) if six else None)


def run_port(name, x, jk, jv, jimp, threshold, delta_mode=False):
    hq, hkv, _, _ = shape_of(name)
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
    hq, hkv, _, _ = shape_of(name)
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
    """Each row's kept V blocks by the kernel's counting rule from per-row
    probability deltas [B, Hq, C], and the smallest gap between a row's
    kb-th and (kb+1)-th block mass among rows that keep any."""
    mass = delta.reshape(delta.shape[:2] + (-1, VB)).sum(-1)
    srt = -np.sort(-mass, axis=-1)
    kth, nxt = srt[..., kb - 1:kb], srt[..., kb:kb + 1]
    keep = (mass >= kth) & (mass > 0)
    live = kth[..., 0] > 0
    return keep, float((kth - nxt)[..., 0][live].min())


@pytest.mark.parametrize("name", list(SHAPES))
def test_k1_plain_matches_pallas_past_group_8(name):
    hq, hkv, d, six = SHAPES[name]
    group = hq // hkv
    assert tfd.instance_group(group) == 8 and tfd.plane_rows(group) == 16
    check_against_pallas(name)


@pytest.mark.parametrize("name", list(WIDE_SHAPES))
def test_k1_plain_matches_pallas_past_256_lanes(name):
    hq, hkv, d, six = WIDE_SHAPES[name]
    assert tfd.instance_dim(d) == 256 and tfd.lane_pieces(d) > 1
    assert tfd.k1_shape_error(hq // hkv, d, CAP, CAP, VB) is None
    jfd._heads_per_program(hkv, CAP, d, hq // hkv)   # the JAX kernel's too
    check_against_pallas(name)


def check_against_pallas(name):
    """K1's plain version vs interpret mode on ``name``'s inputs: planes
    after the append exact, the requant split exact, out and max prob
    within TOL, importance one bf16 step, and the kept V blocks from the
    per-row deltas of a second call in delta mode exact."""
    hq, hkv, d, six = shape_of(name)
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


HEAD_DIMS = (64, 80, 96, 100, 112, 128, 160, 192, 248, 252, 256) + tuple(
    range(272, 4097, 16))
CAPACITIES = (1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
V_BLOCKS = (4, 8, 16, 64)


def test_k1_takes_every_shape_the_jax_kernel_takes():
    """The sweep: kv heads 1-32, groups 1-16, ``HEAD_DIMS`` (up to 256,
    then 272-4096 in steps of 16), ``CAPACITIES`` and ``V_BLOCKS``.
    Where the JAX kernel's fit rule finds a head grouping, K1 takes the
    shape; past 256 lanes after a box row's lead-in (252 needs 264) it
    runs in <G, 256> as lane pieces.  The widest head the JAX kernel takes
    is 3,712 lanes at capacity 1024 (1,792 at 4096 and 16384, 1,408 at
    131072)."""
    taken = wide = 0
    widest = {}
    for d in HEAD_DIMS:
        pieces = tfd.lane_pieces(d)
        assert (pieces > 1) == (d + tfd._lead_in(d) > 256)
        for group in range(1, 17):
            for cap in CAPACITIES:
                if not any(_jax_takes(hkv, cap, d, group)
                           for hkv in range(1, 33)):
                    continue
                widest[cap] = max(widest.get(cap, 0), d)
                for vb in V_BLOCKS:
                    err = tfd.k1_shape_error(group, d, cap, cap, vb)
                    assert err is None, (group, d, cap, vb, err)
                    taken += 1
                    wide += pieces > 1
    assert widest[1024] == 3712 and widest[4096] == 1792
    assert widest[16384] == 1792 and widest[131072] == 1408
    assert taken > 10000 and wide > 5000


def _jax_takes(hkv, cap, d, group) -> bool:
    try:
        jfd._heads_per_program(hkv, cap, d, group)
    except ValueError:
        return False
    return True


def card_branch(monkeypatch, cfg, lengths, seed=0):
    """One K1 call down the wrapper's card branch on CPU tensors
    (``is_cuda`` patched): the recorded launch, its pointer arguments
    given as the tensors themselves."""
    launched = []
    monkeypatch.setattr(tfd.kernels, "launch",
                        lambda name, *args: launched.append((name, args)))
    monkeypatch.setattr(tfd.kernels, "ptr", lambda t: t)
    count = tfd.fused_decode_attention.launches
    m = cfg.model
    g = torch.Generator().manual_seed(seed)
    b = len(lengths)
    st = random_state(cfg, b, g, "cpu")
    q = torch.randn((b, m.num_heads, 1, m.head_dim), generator=g)
    kv = torch.randn((b, m.num_kv_heads, 1, m.head_dim), generator=g)
    try:
        with monkeypatch.context() as mp:
            mp.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
            tfd.fused_decode_attention(
                q, st.cache.k, st.cache.v, kv, kv,
                torch.tensor(lengths, dtype=torch.int32), layer=0,
                v_block_size=cfg.pruning.v_block_size, v_keep=(
                    cfg.engine.cache_capacity // 4,),
                importance_in=st.importance)
    finally:
        tfd.fused_decode_attention.launches = count
    [(kernel, args)] = launched
    assert kernel == "fused_decode"
    return args


def one_layer(hq, hkv, d, cap, vb):
    return tcfg.SpAttenConfig(
        model=tcfg.ModelConfig(vocab_size=64, hidden_size=hq * d,
                               num_layers=1, num_heads=hq, num_kv_heads=hkv,
                               head_dim=d, intermediate_size=64),
        pruning=tcfg.PruningConfig(start_size=2, important_size=8,
                                   recent_size=16, v_block_size=vb),
        engine=tcfg.EngineConfig(cache_capacity=cap, prefill_chunk=8)
    ).validate()


def test_group_16_launches_in_chunks(monkeypatch):
    """Llama-3.1-405B's group over 2 kv heads, capacity 256: the <8, 128>
    instance, the live group 16 (Hq / Hkv), a score plane of 16 rows in
    device memory (the group-8 plan alone would fit shared memory) and
    the block arrays in shared memory."""
    cfg = one_layer(32, 2, 128, 256, 16)
    assert tfd.scores_in_smem(8, 128, 256, 16)
    args = card_branch(monkeypatch, cfg, [200])
    b, hq, hkv, inst, dim, d = args[23:29]
    assert (b, hq, hkv, inst, dim, d) == (1, 32, 2, 8, 128, 128)
    assert tuple(args[22].shape) == (1, 2, 16, 256)
    assert args[22].dtype == torch.float32
    assert args[-1] is None


def test_long_window_launches_with_a_block_plane(monkeypatch):
    """1 kv head of group 8 at 65,536 tokens, v_block 16: past 44,288
    tokens the plan with the score plane in device memory passes 227 KB,
    so the per-V-block arrays get a device plane too: 16-byte slices of
    ``block_bytes(8, 4096)`` per CTA."""
    cap, nvb = 65536, 4096
    for tokens, blocks in ((44288, True), (44304, False), (cap, False)):
        plan = tfd.k1_plan(8, 128, tokens, 16)
        assert not plan.scores_in_smem and plan.blocks_in_smem is blocks
        assert plan.smem <= 227 * 1024
    args = card_branch(monkeypatch, one_layer(8, 1, 128, cap, 16),
                       [cap, 40001])
    assert args[26] == 8 and tuple(args[22].shape) == (2, 1, 8, cap)
    stride = -(-tfd.block_bytes(8, nvb) // 16) * 16
    assert tuple(args[-1].shape) == (2, 1, stride)
    assert args[-1].dtype == torch.uint8


@pytest.mark.parametrize("hq,hkv,d,pieces", [(4, 2, 320, 2), (8, 1, 512, 2),
                                               (1, 1, 1024, 4)])
def test_head_dim_past_256_lanes_launches_in_pieces(monkeypatch, hq, hkv, d,
                                                    pieces):
    """Head dims the JAX kernel takes past 256 lanes (320 over two kv
    heads, 512 and 1024 over one): the card branch launches the
    <G, 256> instance with the live head_dim, which the kernel reads in
    ``lane_pieces`` boxes; the shared-memory plan is the 256 instance's."""
    jfd._heads_per_program(hkv, 4096, d, hq // hkv)   # the JAX kernel's
    assert tfd.k1_shape_error(hq // hkv, d, 4096, 4096, 16) is None
    assert tfd.lane_pieces(d) == pieces
    args = card_branch(monkeypatch, one_layer(hq, hkv, d, 64, 8), [20])
    b, nq, nkv, inst, dim, live = args[23:29]
    assert (b, nq, nkv, dim, live) == (1, hq, hkv, 256, d)
    assert inst == tfd.instance_group(hq // hkv)
    assert tfd.k1_plan(hq // hkv, d, 64, 8) == tfd.k1_plan(hq // hkv, 256,
                                                           64, 8)


def kth_by_bits(m, k):
    """The device-plane instances' k-th largest block mass
    (``warp_kth_largest`` in ``csrc/fused_decode.cu``) in numpy: the
    largest bit pattern T with at least k masses >= T, bit by bit."""
    bits = m.astype(np.float32).view(np.uint32)
    t = 0
    for bit in range(30, -1, -1):
        if int((bits >= (t | 1 << bit)).sum()) >= k:
            t |= 1 << bit
    return np.array([t], np.uint32).view(np.float32)[0]


def kth_by_count(m, k):
    """The shared-plane instances' rule: the smallest mass whose
    strictly-greater count is below k."""
    return m[(m[None, :] > m[:, None]).sum(1) < k].min()


@pytest.mark.parametrize("case", ["random", "ties", "zeros", "k past n",
                                  "one block"])
def test_kth_by_bits_keeps_what_counting_keeps(case):
    """The two rules K1 uses for a row's k-th largest V-block mass keep
    the same blocks (mass >= k-th and > 0) and, where k <= n, find the
    same value; the .cu's search runs over the same bits."""
    rng = np.random.default_rng(7)
    n, k = {"random": (4096, 1024), "ties": (256, 64), "zeros": (512, 300),
            "k past n": (64, 100), "one block": (1, 1)}[case]
    m = rng.dirichlet(np.ones(n)).astype(np.float32)
    if case == "ties":
        m = rng.choice(m[:5], n).astype(np.float32)
    if case == "zeros":
        m[rng.permutation(n)[:n // 2]] = 0.0
    a, b = kth_by_bits(m, k), kth_by_count(m, k)
    assert np.array_equal((m >= a) & (m > 0), (m >= b) & (m > 0))
    if k <= n:
        assert a == b
    cu = Path(tfd.__file__).parents[1] / "csrc" / "fused_decode.cu"
    assert "for (int bit = 30; bit >= 0; --bit)" in cu.read_text()
