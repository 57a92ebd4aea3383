"""Mean prompt rows an admission's prefill chunk carries (the ``rows``
of the ``engine.prefill`` spans under ``server.admission``), over every
tick of the traced run's window (``program_trace.prefill_rows``)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.prefill_rows(obs, spans)
