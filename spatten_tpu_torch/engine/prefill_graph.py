"""A batch-1, full-length prefill chunk replayed from a captured CUDA graph.

The server prefills each admission one chunk a tick at batch 1, and on
the card the host's eager dispatch of such a chunk (some 300 small aten
ops a layer) takes several times the card's time to run them.
``PrefillGraph`` captures ``transformer.forward`` of one chunk of
``prefill_chunk`` tokens once, on a batch-1 staging state of its own, and
replays it for every chunk of that shape:

1. the admission's state (every cache plane, the importance accumulator,
   both lengths, the head mask, the requant count, the pass-1 bits) is
   copied into the staging state (``load``), the token ids into the
   static token buffer;
2. the graph replays the kernels the eager forward launches, on the same
   shapes and dtypes, so the staging state ends as the eager forward
   leaves its state;
3. the planes and the importance are copied back into the admission's
   own tensors (``store``), and the state returned holds new tensors for
   the lengths and the requant count, cloned from the graph's outputs,
   as the eager forward returns new ones.

``engages`` is the rule for where it applies, read from what the code
sees: a CUDA tensor of ``(1, prefill_chunk)`` tokens with a chunk longer
than one token (a one-token chunk is K1's), and a forward that reads
nothing on the host (no per-layer pass-1 bits: ``forward`` reads each
layer's on the host when ``layer_bits`` is set).  Everything else runs
eagerly.  The prune before a chunk (``generate.maybe_prune``) stays eager
and runs first, on the admission's own state.

The graph replays the forward it captured: a patch of
``transformer.forward`` sees the capture's call and none of the replays,
so a check that follows every forward call (``kernel_checks._CpuReplay``)
hooks ``PrefillGraph.run`` too, and lets the capture see the unpatched
forward.

Under the tracer (``utils.profiling.tracer``) the capture is span
``engine.prefill_capture`` and each chunk's copies and replay
``engine.prefill_replay``, both children of ``engine.prefill``; a graph
of an expert model captured with the tracer on also outputs each expert
layer's row counts, which the replay span notes as ``experts_hit``
(the graph's ``moe.layer`` spans ran at the capture only).
"""

from __future__ import annotations

import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.engine.state import DecodeState, init_state
from spatten_tpu_torch.models import transformer
from spatten_tpu_torch.utils.profiling import tracer


def engages(cfg: SpAttenConfig, device_type: str, shape) -> bool:
    """Whether a prefill chunk of token ``shape`` on a ``device_type``
    tensor replays from the graph."""
    chunk = cfg.engine.prefill_chunk
    q = cfg.quant
    return (device_type == "cuda" and chunk > 1
            and tuple(shape) == (1, chunk)
            and not (q.enabled and q.layer_bits is not None))


def _planes(state: DecodeState) -> list:
    """The state's cache planes and importance, in a fixed order."""
    return [x for x in state.cache.k + state.cache.v
            if x is not None] + [state.importance]


def load(staging: DecodeState, state: DecodeState) -> None:
    """Copy every field of ``state`` into ``staging`` (same shapes)."""
    for dst, src in zip(_planes(staging), _planes(state)):
        dst.copy_(src)
    for name in ("lengths", "layer_lengths", "head_mask", "requant_events",
                 "quant_bits"):
        getattr(staging, name).copy_(getattr(state, name))


def store(state: DecodeState, staging: DecodeState) -> None:
    """Copy the cache planes and importance of ``staging`` back into
    ``state``'s own tensors (a forward changes no other field in place)."""
    for dst, src in zip(_planes(state), _planes(staging)):
        dst.copy_(src)


class PrefillGraph:
    """One captured forward of a batch-1 chunk of ``prefill_chunk`` tokens
    over ``params`` and ``cfg``, captured at the first ``run``.
    ``replays`` counts the chunks it ran."""

    def __init__(self, params, cfg: SpAttenConfig):
        self.params, self.cfg = params, cfg
        self.staging: DecodeState | None = None
        self.ids: torch.Tensor | None = None
        self.graph = None
        self.out: tuple | None = None     # the graph's output tensors
        self.replays = 0

    def forward(self) -> tuple:
        """The forward on the staging state and token buffer: (last-token
        logits, lengths, layer lengths, requant count, the call's requant
        count, max probs, requants by layer[, expert counts])."""
        logits, st, aux = transformer.forward(self.params, self.cfg,
                                              self.staging, self.ids)
        # a graph outputs tensors: the expert counts only where the
        # forward gives them (the last field, so the others keep their
        # places)
        return (logits[:, -1], st.lengths, st.layer_lengths,
                st.requant_events) + tuple(x for x in aux if x is not None)

    def capture(self, tokens: torch.Tensor) -> None:
        """Make the staging state and token buffer on ``tokens``' card, run
        the forward once eagerly on a side stream, then capture it."""
        dev = tokens.device
        self.staging = init_state(self.cfg, batch=1, device=dev)
        self.ids = torch.zeros_like(tokens)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.forward()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.out = self.forward()
        self.graph = graph

    def run(self, state: DecodeState, tokens: torch.Tensor):
        """``transformer.forward(params, cfg, state, tokens)`` from the
        graph: the planes and importance of ``state`` are updated in place
        (consumed).  Returns (last-token logits [1, V], state, aux), every
        tensor new apart from the planes and importance."""
        if self.graph is None:
            with tracer.span("engine.prefill_capture"):
                self.capture(tokens)
        with tracer.span("engine.prefill_replay") as span:
            load(self.staging, state)
            self.ids.copy_(tokens)
            self.graph.replay()
            store(state, self.staging)
            self.replays += 1
            last, lengths, layer_lengths, events, *aux = (
                x.clone() for x in self.out)
            aux = transformer.StepAux(*aux)
            if aux.expert_counts is not None:
                # captured with the tracer on: the replay's expert counts
                span.note(experts_hit=aux.expert_counts)
            return last, state._replace(
                lengths=lengths, layer_lengths=layer_lengths,
                requant_events=events), aux
