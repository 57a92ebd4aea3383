"""The program's ``sync.*`` spans a server tick, over every tick of the
traced run's window (``program_trace.syncs_per_tick``)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.syncs_per_tick(obs,
                                                                    spans)
