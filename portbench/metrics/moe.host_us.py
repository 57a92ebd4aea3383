"""Host us a ``moe.layer`` span takes (an expert layer's router, sort,
grouped GEMMs, combine and shared experts, issued), in the traced run's
window outside the profiled stretch.  Nothing to read for a model with
no expert layer, or where the program has no such span."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    if spans is None:
        return None
    us = [spans[j].ms * 1e3
          for profiled, _, under in program_trace.tick_trees(obs, spans)
          if not profiled for j in under if spans[j].name == "moe.layer"]
    return sum(us) / len(us) if us else None
