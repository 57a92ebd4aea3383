"""Host ms per admission prefill chunk (``generate.prefill_chunk`` as the
server issues it, one chunk per admission a tick), synchronised, in the
traced run's window outside the profiled stretch."""


def read(obs):
    spans = obs.window_spans("engine.prefill_chunk")
    if not spans:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans)
