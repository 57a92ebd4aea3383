"""Host ms per server tick (``SpAttenServer.step``) in the traced run's
window, the profiled stretch left out (the profiler slows it)."""


def read(obs):
    rec = obs.rec
    ticks = [k for k in range(obs.first_tick, obs.last_tick)
             if not rec.tick_info[k]["profiled"]]
    if not ticks:
        return None
    return 1e3 * sum(rec.tick_end[k] - rec.tick_start[k]
                     for k in ticks) / len(ticks)
