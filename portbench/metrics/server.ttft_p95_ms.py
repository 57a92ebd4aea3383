"""95th percentile (nearest rank) of the time from ``submit`` to the end
of the tick that emitted the first token, over every request submitted
in the window; one still waiting at the window's end counts its wait so
far.  In ms.  Read in the traced run, whose wrapped calls synchronise
outside the profiled stretch."""

from portbench import counts


def read(obs):
    if not obs.ttfts:
        return None
    return 1e3 * counts.percentile(obs.ttfts, 0.95)
