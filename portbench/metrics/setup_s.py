"""Seconds from the process's start to the window's start: the kernels
built or loaded, the weights made, the clients' first requests staged
and the warm-up ticks run."""


def read(obs):
    return obs.setup_s
