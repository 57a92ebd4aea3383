"""Continuous-batching serving engine over a slot-based KV arena (port of
``spatten_tpu/engine/server.py``).

The decode state's batch dimension is an arena of ``max_batch_size``
slots.  Requests are admitted into free slots, decode steps advance every
slot in lockstep (empty slots compute values that are never read), and
finished slots are released out of order and recycled.

Admission is overlapped: a new request's prompt prefills one chunk per
scheduler tick into a private batch-1 state, interleaved with the
arena's decode steps, so a long prompt never stalls running decodes.
When the prefill completes, ``state.write_slot`` copies the sub-state
into the reserved slot and the request joins the next decode step.  With
nothing decoding, a tick still advances every admission by one chunk.
On the card an admission's full-length chunks replay from one captured
CUDA graph (``engine/prefill_graph.py``), shared by every admission; a
ragged last chunk runs eagerly.

The same two engine steps as ``generate`` run here: ``prefill_chunk``
(with its prunes checked on the host, as lengths differ per request) and
``decode_step`` (the prune and head mask update when due, then one
``forward``: on the card K1 for every layer, and K2 for a prune's
compaction where it takes the head_dim).  Admission and release are host
bookkeeping plus one in-place scatter.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from spatten_tpu_torch.config import SpAttenConfig
from spatten_tpu_torch.device import resolve_device
import spatten_tpu_torch.engine.generate as gen
from spatten_tpu_torch.engine.prefill_graph import PrefillGraph
from spatten_tpu_torch.engine.state import (
    DecodeState, init_state, write_slot,
)
from spatten_tpu_torch.utils.profiling import tracer


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # int32 [prompt_len]
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    next_token: Optional[int] = None
    done: bool = False


@dataclass
class _Admission:
    """A request whose prompt is being prefilled, one chunk per tick."""

    req: Request
    slot: int                          # reserved arena slot
    sub: DecodeState                   # private batch-1 state
    pos: int = 0
    last_logits: Optional[torch.Tensor] = None


class SpAttenServer:
    """Host-side scheduler over the engine's prefill and decode steps.

    Runs on ``device`` (default CUDA; raises when CUDA is missing), where
    ``params`` must already live."""

    def __init__(self, params, cfg: SpAttenConfig,
                 eos_token_id: Optional[int] = None,
                 device: str | torch.device = "cuda"):
        cfg.validate()
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not on {self.device}")
        self.params = params
        self.cfg = cfg
        self.eos = eos_token_id
        self.batch = cfg.engine.max_batch_size
        self.state = init_state(cfg, batch=self.batch, device=self.device)
        self.free_slots = list(range(self.batch))
        self.active: Dict[int, Request] = {}     # slot -> request
        self.admitting: List[_Admission] = []    # slot reserved, prefilling
        self.pending: List[Request] = []
        self.finished: List[Request] = []
        self._ids = itertools.count()
        # every admission's full-length chunks replay from one graph
        self.prefill_graph = PrefillGraph(params, cfg)

    # -- client API ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int) -> int:
        """Queue a request; returns its id."""
        req = Request(request_id=next(self._ids),
                      prompt=np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens=max_new_tokens)
        self.pending.append(req)
        return req.request_id

    def step(self) -> List[Request]:
        """One scheduler tick: start admissions, advance each in-flight
        prefill by ONE chunk, run one arena decode step over the active
        slots, release finished.  Returns requests completed this tick.

        Under the tracer (``utils.profiling.tracer``) the tick is span
        ``server.tick``; its children cover the server's own work
        (``server.admit``, one ``server.admission`` per in-flight
        admission, ``server.decode_input``, ``server.release``) and the
        engine's, whose spans open inside the engine functions."""
        with tracer.span("server.tick"):
            with tracer.span("server.admit"):
                self._start_admissions()
            self._advance_admissions()

            if not self.active:
                return self._drain_finished()

            # one lockstep decode over the arena; empty slots compute
            # values that are never read (their cache is overwritten on
            # admission)
            with tracer.span("server.decode_input"):
                tokens = np.zeros((self.batch,), np.int32)
                for slot, req in self.active.items():
                    tokens[slot] = req.next_token
                with tracer.sync("server.decode_ids"):
                    ids = torch.from_numpy(tokens).to(self.device)
            next_tokens, self.state, _ = gen.decode_step(
                self.params, self.cfg, self.state, ids)

            with tracer.span("server.release"):
                with tracer.sync("server.tokens"):
                    next_tokens = next_tokens.cpu().tolist()
                for slot in list(self.active):
                    req = self.active[slot]
                    req.generated.append(int(req.next_token))
                    emitted = len(req.generated)
                    if (self.eos is not None and req.next_token == self.eos) \
                            or emitted >= req.max_new_tokens:
                        req.done = True
                        self.finished.append(req)
                        del self.active[slot]
                        self.free_slots.append(slot)  # out-of-order release
                    else:
                        req.next_token = next_tokens[slot]
            return self._drain_finished()

    def run_to_completion(self, max_steps: int = 10_000) -> List[Request]:
        out: List[Request] = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self.active and not self.pending and not self.admitting:
                break
        return out

    # -- internals ----------------------------------------------------------

    def _start_admissions(self) -> None:
        """Reserve slots for pending requests (no prefill work here)."""
        while self.pending and self.free_slots:
            req = self.pending.pop(0)
            slot = self.free_slots.pop(0)
            self.admitting.append(_Admission(
                req=req, slot=slot,
                sub=init_state(self.cfg, batch=1, device=self.device)))

    def _advance_admissions(self) -> None:
        """Run ONE prefill chunk for every in-flight admission; scatter
        completed prefills into their reserved arena slots."""
        chunk = self.cfg.engine.prefill_chunk
        still: List[_Admission] = []
        for adm in self.admitting:
            with tracer.span("server.admission",
                             request=adm.req.request_id):
                prompt = adm.req.prompt
                n = min(chunk, len(prompt) - adm.pos)
                with tracer.sync("server.prompt_ids"):
                    ids = torch.from_numpy(
                        prompt[None, adm.pos:adm.pos + n]).to(self.device)
                adm.last_logits, adm.sub, _ = gen.prefill_chunk(
                    self.params, self.cfg, adm.sub, ids,
                    graph=self.prefill_graph)
                adm.pos += n
                if adm.pos < len(prompt):
                    still.append(adm)
                    continue
                with tracer.sync("server.first_token"):
                    first = int(torch.argmax(adm.last_logits, dim=-1)[0])
                with tracer.span("server.write_slot"):
                    self.state = write_slot(self.state, adm.sub, adm.slot)
                adm.req.slot = adm.slot
                adm.req.next_token = first
                self.active[adm.slot] = adm.req
        self.admitting = still

    def _drain_finished(self) -> List[Request]:
        out, self.finished = self.finished, []
        return out
