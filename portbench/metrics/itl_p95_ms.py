"""95th percentile (nearest rank) over every gap between consecutive
tokens of a request, both inside the window, of all requests, in ms."""

from portbench import counts


def read(obs):
    if not obs.gaps:
        return None
    return 1e3 * counts.percentile(obs.gaps, 0.95)
