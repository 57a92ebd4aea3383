"""Share of the ``engine.prefill`` spans (``generate.prefill_chunk``)
that hold an ``engine.prefill_replay`` (a full-length chunk replayed from
the captured CUDA graph), in %, by count, over the traced run's window
outside the profiled stretch (``program_trace.by_name``).  0 where every
chunk ran eagerly."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    if spans is None:
        return None
    names = program_trace.by_name(obs, spans)
    prefill = names.get("engine.prefill", [0, 0.0, 0.0])[0]
    if prefill <= 0:
        return None
    replay = names.get("engine.prefill_replay", [0, 0.0, 0.0])[0]
    return 100.0 * replay / prefill
