"""Host ms per ``generate.decode_step`` (the prune and head-mask checks
and one forward over every slot), synchronised, in the traced run's
window outside the profiled stretch."""


def read(obs):
    spans = obs.window_spans("engine.decode_step")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans)
