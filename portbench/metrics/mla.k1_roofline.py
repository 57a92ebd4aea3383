"""K1's (``csrc/fused_decode.cu``) share of its roofline over the
profiled stretch on a latent (MLA) cache, in %: the bytes the stretch's
fused decode attention calls need (the model path's ``counts.k1_bytes``
with ``k1.roofline``'s arguments and the cached head's live query
heads: the latent row's key lanes, the kept V rows at the latent lanes, per
layer and tick, fed the slots' live lengths, the head mask in force, the
requants the step reported and the kept V blocks) over K1's device time
times 3.35 TB/s.  A layer's requants are given to its shortest live
rows, so the count errs low.  Nothing to read for a model whose cache
holds K/V heads (``k1.roofline`` reads those; it takes the reference's
``kv_heads``, which for the latent model are the head mask's 16
groups, as cached heads)."""

from portbench import counts


def read(obs):
    st, knobs = obs.stretch, obs.knobs
    if not st or not hasattr(knobs, "cache_heads"):
        return None
    k1_s, k1_n = st["k1"]
    if not k1_n or k1_s <= 0:
        return None
    s = obs.config["spatten"]
    sb = 2 if s["scale_dtype"] == "bfloat16" else 4
    ib = 2 if s["importance_dtype"] == "bfloat16" else 4
    total = 0
    for k in st["ticks"]:
        info = obs.rec.tick_info[k]
        if info["requants"] is None:
            continue
        lens, mask = info["lens"], info["mask"]
        hc, g = knobs.cache_heads, knobs.cache_group
        for l in range(knobs.layers):
            n_l = [int(x) for x in lens[l]]
            # the query heads alive under each cached head
            live = mask[l].reshape(hc, g).sum(-1).tolist()
            alive = [[x > 0 for x in live] for _ in n_l]
            pairs = sorted((n, b, h) for b, n in enumerate(n_l)
                           for h in range(hc) if live[h])
            fired = [[False] * hc for _ in n_l]
            for n, b, h in pairs[:int(info["requants"][l])]:
                fired[b][h] = True
            kb = knobs.keep_blocks(l)
            kept = [[min(kb * knobs.v_block, n) if kb else n] * hc
                    for n in n_l]
            total += obs.counts.k1_bytes(
                n_l, alive, fired, kept, kv_heads=hc, group=g,
                head_dim=knobs.head_dim, capacity=knobs.cap,
                rung=knobs.rungs[l], scale_bytes=sb, imp_bytes=ib,
                rope=knobs.rope, live_heads=[live] * len(n_l))
    if total == 0:
        return None
    return 100.0 * total / (k1_s * counts.PEAK_HBM_BYTES_PER_S)
