"""The expert layers' grouped GEMMs' share of their roofline over the
profiled stretch, in %: the bytes the stretch's expert layers need (the
model path's ``counts.moe_bytes`` of each layer's rows per expert, the
program's counter ``moe.experts_hit``: on each eager ``moe.layer`` span,
and per expert layer on each replayed prefill chunk's span) over the
grouped GEMM kernels' device time times 3.35 TB/s.  Nothing to read where
the program keeps no such counter or the trace holds no grouped GEMM."""

from portbench import counts, program_trace

# the device kernel of torch._grouped_mm on the card: a CUTLASS GEMM over
# a GroupProblemShape (its pointer-preparing kernel is not counted)
GROUPED_GEMM = ("GroupProblemShape",)


def _grouped_s(ops) -> float:
    return sum(e - s for s, e, name in ops
               if any(n in name for n in GROUPED_GEMM)) * 1e-6


def read(obs):
    st, spans = obs.stretch, getattr(obs, "program", None)
    moe_bytes = getattr(obs.counts, "moe_bytes", None)
    if not st or spans is None or moe_bytes is None:
        return None
    t = _grouped_s(st["ops"])
    if t <= 0:
        return None
    c = obs.config
    total = 0
    for profiled, _, under in program_trace.tick_trees(obs, spans):
        if not profiled:
            continue
        for j in under:
            hits = spans[j].attrs.get("experts_hit")
            if not hits:
                continue
            for h in (hits if isinstance(hits[0], list) else [hits]):
                total += moe_bytes(h, c["hidden_size"],
                                   c["moe_intermediate_size"])
    if total == 0:
        return None
    return 100.0 * total / (t * counts.PEAK_HBM_BYTES_PER_S)
