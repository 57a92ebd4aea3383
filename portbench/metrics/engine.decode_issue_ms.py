"""Host ms an ``engine.decode`` span (``generate.decode_step``) takes
less its sync waits, in the traced run's window outside the profiled
stretch (``program_trace.decode_issue_ms``)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.decode_issue_ms(obs,
                                                                     spans)
