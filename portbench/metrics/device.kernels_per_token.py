"""Device operations (kernels, copies, fills) in the profiled stretch per
token emitted there."""


def read(obs):
    st = obs.stretch
    if not st or not st["tokens"]:
        return None
    return st["kernels"] / st["tokens"]
