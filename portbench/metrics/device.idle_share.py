"""Share of the profiled stretch in which no kernel, copy or fill ran on
the card, in % (torch.profiler's device trace)."""


def read(obs):
    st = obs.stretch
    if not st or st["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - st["busy_s"] / st["window_s"])
