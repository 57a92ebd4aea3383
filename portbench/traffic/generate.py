"""The one traffic generator: reads a mix's parameters (``<name>.json``
beside this file) and hands the harness requests made from the seed.

Two kinds of mix:

* ``staged_sessions``: one session per slot but the ``churn`` clients'.
  History lengths lie on an even grid of ``history_groups`` values over
  [history_min, history_max] (each value used sessions / groups times),
  so every seed brings the same set of lengths in another order; the
  sessions are staged before the window in groups of equal length and
  then decode with no end inside the window (``max_new_tokens``).  The
  ``churn`` clients (if any) send short requests in a closed loop, as
  ``closed_loop`` clients do, from pools of their own.
* ``closed_loop``: one client per slot.  Each client's first request is
  staged before the window (prompt ``stage_prompt``, an output drawn as
  the residual of a request already under way, so completions are spread
  from the first tick); from then on a client sends its next request as
  soon as its last one finishes.  Prompt and output lengths come from a
  pool of ``pool`` lognormal quantiles (median, sigma, clipped to
  [min, max]), the same pool for every seed, dealt in a seed-drawn order.
  With ``strata`` the order is balanced: the sorted pool is cut into that
  many equal runs, and every ``strata`` consecutive requests hold one
  length of each run, so whatever share of the pool a window reaches, it
  holds the same mix of lengths for every seed.

Token ids are uniform over the vocabulary, drawn from (seed, request
index), so a request's ids do not depend on the order requests are
made in.  Nothing here touches a device.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist
from typing import Optional

import numpy as np

TRAFFIC_DIR = Path(__file__).resolve().parent


@dataclass
class Req:
    client: int
    index: int                 # request number within the run
    prompt: np.ndarray         # int32 [prompt_len]
    max_new_tokens: int


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    """The parameters of traffic mix ``name`` (``<directory>/<name>.json``)."""
    path = Path(directory) / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic file {path}")
    return json.loads(path.read_text())


def balanced_order(values: np.ndarray, rng: np.random.Generator,
                   strata: int) -> np.ndarray:
    """``values`` in an order drawn from ``rng`` in which each of the
    consecutive rounds of ``strata`` entries holds one value of every
    stratum (the sorted values cut into ``strata`` equal runs): any prefix
    of the order holds each stratum's share, to one value."""
    v = np.sort(np.asarray(values))
    if len(v) % strata:
        raise ValueError(f"a pool of {len(v)} does not split into "
                         f"{strata} strata")
    picks = np.stack([rng.permutation(run)
                      for run in v.reshape(strata, -1)])
    return np.concatenate([picks[rng.permutation(strata), r]
                           for r in range(picks.shape[1])])


def lognormal_pool(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at the quantiles (i + 0.5) / n of a lognormal of the
    given median and sigma, clipped to [min, max]: int64 [n]."""
    nd = NormalDist()
    q = [(i + 0.5) / n for i in range(n)]
    vals = [spec["median"] * math.exp(spec["sigma"] * nd.inv_cdf(x))
            for x in q]
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


class Traffic:
    """Requests of one run: ``staged()`` once, then ``next_request`` for
    a client whose last request finished (None: the client is done)."""

    def __init__(self, spec: dict, seed: int, slots: int, vocab: int):
        self.spec = spec
        self.seed = int(seed)
        self.slots = slots
        self.vocab = vocab
        self.kind = spec["kind"]
        self._count = 0
        order = np.random.default_rng([self.seed, 0])
        self._next = 0
        if self.kind == "staged_sessions":
            loop = spec.get("churn")
            self.sessions = slots - (loop["clients"] if loop else 0)
            groups = spec["history_groups"]
            if self.sessions % groups:
                raise ValueError(f"{self.sessions} sessions do not split "
                                 f"into {groups} history groups")
            lo, hi = spec["history_min"], spec["history_max"]
            grid = [int(round(lo + (hi - lo) * (g + 0.5) / groups))
                    for g in range(groups)]
            self._history = order.permutation(
                np.repeat(grid, self.sessions // groups))
        elif self.kind == "closed_loop":
            loop = spec
            self.sessions = 0
        else:
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        if loop:
            n = loop["pool"]
            self._loop = loop
            strata = loop.get("strata")

            def deal(lengths):
                return (balanced_order(lengths, order, strata) if strata
                        else order.permutation(lengths))
            self._prompts = deal(lognormal_pool(loop["prompt"], n))
            self._outputs = deal(lognormal_pool(loop["output"], n))
            clients = slots - self.sessions
            frac = (np.arange(clients) + 0.5) / clients
            if strata:
                # the staged outputs paired with their residuals by rank,
                # through one fixed shuffle: the same residual work for
                # every seed, dealt to the clients in the seed's order
                full = self._outputs[np.arange(clients) % n]
                rank = np.argsort(np.argsort(full, kind="stable"),
                                  kind="stable")
                self._residual = frac[
                    np.random.default_rng(0).permutation(clients)[rank]]
            else:
                self._residual = order.permutation(frac)

    def _ids(self, index: int, length: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 1, index])
        return rng.integers(0, self.vocab, size=length, dtype=np.int64
                            ).astype(np.int32)

    def _make(self, client: int, length: int, max_new: int) -> Req:
        index = self._count
        self._count += 1
        return Req(client, index, self._ids(index, length), int(max_new))

    def staged(self) -> list[Req]:
        """The requests staged before the window, one per client: each
        session with its history; each closed-loop client a request of
        ``stage_prompt`` tokens and an output drawn as the residual of
        one already under way."""
        out = [self._make(c, int(self._history[c]),
                          self.spec["max_new_tokens"])
               for c in range(self.sessions)]
        for i, c in enumerate(range(self.sessions, self.slots)):
            full = int(self._outputs[self._take() % len(self._outputs)])
            out.append(self._make(c, self._loop["stage_prompt"],
                                  max(1, math.ceil(full
                                                   * self._residual[i]))))
        return out

    def _take(self) -> int:
        i = self._next
        self._next += 1
        return i

    def next_request(self, client: int) -> Optional[Req]:
        if client < self.sessions:
            return None
        i = self._take() % len(self._prompts)
        return self._make(client, int(self._prompts[i]),
                          int(self._outputs[i]))
