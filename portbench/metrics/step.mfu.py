"""The model step's share of the card's bf16 peak, in %: the model FLOPs
of every token processed in the traced run's window (2 per weight it
multiplies through, the output head for each decoded token, attention
over the live lengths each layer's cache held) over the window's seconds
times 989 TFLOP/s.  The wrappers' synchronisations slow the traced
window, so this reads below an untraced run."""

from portbench import counts


def read(obs):
    c, model, rec = obs.config, obs.counts, obs.rec
    flops = 0.0
    for k in range(obs.first_tick, obs.last_tick):
        info = rec.tick_info[k]
        for slot in info["slots"]:
            flops += model.token_flops(c, float(info["lens"][:, slot].sum()),
                                       True)
    for t0, t1, (size, lens) in obs.window_spans("engine.prefill_chunk",
                                                 profiled=True):
        ctx = sum(model.chunk_context(n, size) for n in lens)
        flops += size * model.token_flops(c, 0.0, False) \
            + model.attention_flops(c, ctx)
    if flops == 0.0:
        return None
    return 100.0 * flops / (obs.window_s * counts.PEAK_BF16_FLOPS)
