"""K2's (``csrc/compact_gather.cu``) share of its roofline over the
profiled stretch, in %: the bytes its compactions need (each moved
(token, head) row of K and V read and written, the keep lists read;
``counts.k2_bytes``, from each call's keep indices) over K2's device time
times 3.35 TB/s.  Nothing to read where the stretch holds no prune."""

from portbench import counts


def read(obs):
    st = obs.stretch
    if not st:
        return None
    k2_s, k2_n = st["k2"]
    calls = obs.rec.k2_calls
    if not k2_n or k2_s <= 0 or not calls:
        return None
    knobs = obs.knobs
    total = sum(obs.counts.k2_bytes(moved, kept, knobs.kv_heads,
                                    knobs.head_dim) for moved, kept in calls)
    return 100.0 * total / (k2_s * counts.PEAK_HBM_BYTES_PER_S)
