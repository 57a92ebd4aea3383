"""The model step's share of the card's bf16 peak, in %, with the model
path's counts of an expert model: 2 FLOPs per active weight (attention
projections, the router, a token's routed experts and the shared ones),
the output head for each decoded token and attention in the published
form, over the traced window's seconds times 989 TFLOP/s.  The same
reading as ``step.mfu`` (``metrics/step.mfu.py``), under the name of a
count that leaves out the experts a token does not visit."""

from portbench import manifest


def read(obs):
    return manifest.reader("step.mfu")(obs)
