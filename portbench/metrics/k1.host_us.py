"""Host us a ``k1.launch`` span takes (K1's operand checks, allocations
and ctypes call), in the traced run's window outside the profiled
stretch (``program_trace.k1_host_us``).  Nothing to read where K1 is
not launched (the CPU runs its plain version)."""

from portbench import program_trace


def read(obs):
    spans = getattr(obs, "program", None)
    return None if spans is None else program_trace.k1_host_us(obs, spans)
