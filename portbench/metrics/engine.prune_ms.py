"""Host ms per ``generate.maybe_prune`` call that compacted at least one
(layer, slot) (the selection, K2's gather, the re-rotation and repack),
synchronised, in the traced run's window outside the profiled stretch."""


def read(obs):
    spans = [s for s in obs.window_spans("engine.maybe_prune") if s[2]]
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans)
