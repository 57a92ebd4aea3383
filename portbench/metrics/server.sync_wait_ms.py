"""Host ms a server tick spends in the program's ``sync.*`` spans (each
device-to-host read, or host copy that waits, on the tick's path), in
the profiled stretch, where the harness's wrappers do not drain the
device first (``program_trace.sync_wait_ms``)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.sync_wait_ms(obs, spans)
