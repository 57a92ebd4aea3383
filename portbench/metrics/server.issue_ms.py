"""Host ms a server tick spends in its child spans less their sync
waits: the host's own work of a tick (Python, allocation, launches), in
the traced run's window outside the profiled stretch
(``program_trace.issue_ms``, from the program's spans)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.issue_ms(obs, spans)
