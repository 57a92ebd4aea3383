"""K1's (``csrc/fused_decode.cu``) share of its roofline over the
profiled stretch, in %: the bytes the stretch's fused decode attention
calls need (``counts.k1_bytes`` per layer and tick, fed the slots' live
lengths, the head mask in force, the requants the step reported and the
kept V blocks) over K1's device time times 3.35 TB/s.  A layer's
requants are given to its shortest live (slot, head) pairs, so the
count errs low."""

from portbench import counts


def read(obs):
    st = obs.stretch
    if not st:
        return None
    k1_s, k1_n = st["k1"]
    if not k1_n or k1_s <= 0:
        return None
    c, model, rec, knobs = obs.config, obs.counts, obs.rec, obs.knobs
    s = c["spatten"]
    # the cached heads as the model path's reference lays them out
    hkv, g, dh = knobs.kv_heads, knobs.group, knobs.head_dim
    sb = 2 if s["scale_dtype"] == "bfloat16" else 4
    ib = 2 if s["importance_dtype"] == "bfloat16" else 4
    total = 0
    for k in st["ticks"]:
        info = rec.tick_info[k]
        if info["requants"] is None:
            continue
        lens, mask = info["lens"], info["mask"]
        for l in range(knobs.layers):
            n_l = [int(x) for x in lens[l]]
            alive_h = mask[l].reshape(hkv, g).any(-1).tolist()
            alive = [alive_h for _ in n_l]
            pairs = sorted((n, b, h) for b, n in enumerate(n_l)
                           for h in range(hkv) if alive_h[h])
            fired = [[False] * hkv for _ in n_l]
            for n, b, h in pairs[:int(info["requants"][l])]:
                fired[b][h] = True
            kb = knobs.keep_blocks(l)
            kept = [[min(kb * knobs.v_block, n) if kb else n] * hkv
                    for n in n_l]
            total += model.k1_bytes(
                n_l, alive, fired, kept, kv_heads=hkv, group=g,
                head_dim=dh, capacity=knobs.cap, rung=knobs.rungs[l],
                scale_bytes=sb, imp_bytes=ib)
    if total == 0:
        return None
    return 100.0 * total / (k1_s * counts.PEAK_HBM_BYTES_PER_S)
