"""Profiling and tracing hooks (port of ``spatten_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace of host activity and,
where a CUDA device is present, of the card's kernels (CUPTI), and writes
it as a Chrome trace (``chrome://tracing`` or Perfetto) into a directory;
``annotate`` names a region of that timeline.

``tracer`` is the process-wide tracer of the program's own spans: the
serving tick and each layer under it (server, engine, model, the kernels'
host-side launches) and every device-to-host read on the tick's path
(``sync``).  A DeepSeek-V2 model adds ``mla.attention`` (a layer's
latent projections, attention and up-projection) and ``moe.layer`` (an
expert layer: router, sort, grouped GEMMs, combine, shared experts;
``tokens``), whose counter ``moe.experts_hit`` (rows each expert
received) the span keeps as a device tensor until ``drain``.  It is off by default; then a span site returns the shared
no-op ``OFF``, records nothing, reads no clock and touches no device.
When on, each span records its name, ``time.perf_counter_ns()`` at start
and end, its parent and a few host-known attributes, kept in memory until
``drain()``; while a ``torch.profiler`` records, each span also opens an
``annotate`` range of its name, so the device trace's idle gaps fall
under the program's spans.

Usage:
    tracer.enable()
    server.step()
    spans = tracer.drain()      # [Span], parents before their children
    tracer.disable()
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[
        Optional[torch.profiler.profile]]:
    """Record a trace of the block into ``log_dir`` (nothing for None).

    Yields the ``torch.profiler.profile`` (``key_averages()`` sums time
    by op and kernel); on exit the trace is written to
    ``<log_dir>/trace-<time>-<pid>.json``.

    Usage:
        with profile_trace("spatten-trace"):
            generate(...)
    """
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    name = f"trace-{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """Named region of the trace timeline, e.g. ``with
    annotate("prefill-chunk"): ...`` (``torch.profiler.record_function``,
    which also emits an NVTX range under ``emit_nvtx``)."""
    return torch.profiler.record_function(name)


class _Off:
    """The span a disabled tracer hands out: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


OFF = _Off()


class Span:
    """One span: ``name``, host clock ``t0`` and ``t1`` in ns
    (``time.perf_counter_ns``, the clock of ``time.perf_counter``),
    ``parent`` (its enclosing span's index in the drained list, -1 at the
    top) and ``attrs`` (host-known ints: the request id, a chunk's rows
    and tokens, the layers a prune compacted; or a counter kept as a
    device tensor, read into lists by ``drain``)."""

    __slots__ = ("name", "t0", "t1", "parent", "attrs", "_tracer", "_range")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.t0 = self.t1 = None
        self.parent = -1
        self._tracer, self._range = tracer, None

    def __enter__(self) -> "Span":
        tr = self._tracer
        if tr._stack:
            self.parent = tr._stack[-1]
        tr._stack.append(len(tr._spans))
        tr._spans.append(self)
        if torch.autograd._profiler_enabled():
            self._range = annotate(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        self._tracer._stack.pop()
        return False

    def note(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    @property
    def ms(self) -> float:
        return (self.t1 - self.t0) * 1e-6


class Tracer:
    """The program's spans (module docstring).  One per process:
    ``tracer``."""

    def __init__(self):
        self.on = False
        self._spans: list[Span] = []
        self._stack: list[int] = []

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, *, request: Optional[int] = None,
             rows: Optional[int] = None, tokens: Optional[int] = None):
        """A context manager timing its block as span ``name``, with the
        attributes given; ``OFF`` while the tracer is off."""
        if not self.on:
            return OFF
        attrs = {k: v for k, v in (("request", request), ("rows", rows),
                                   ("tokens", tokens))
                 if v is not None}
        return Span(self, name, attrs)

    def sync(self, site: str):
        """Span ``sync.<site>`` around one device-to-host read (or a host
        copy to the device that waits for it) on the serving path; the
        read inside runs exactly as it would untraced."""
        if not self.on:
            return OFF
        return Span(self, "sync." + site, {})

    def drain(self) -> list[Span]:
        """The spans recorded since the last drain, in the order they
        opened (a parent before its children), and forget them.  Call it
        with no span open."""
        if self._stack:
            raise RuntimeError(f"drain() inside the open span "
                               f"{self._spans[self._stack[-1]].name!r}")
        out, self._spans = self._spans, []
        _read_tensors(out)
        return out


def _read_tensors(spans: list[Span]) -> None:
    """Replace each device tensor a span noted (a counter kept on the
    device, such as an expert layer's ``experts_hit``) by its values as
    nested lists: one read a device for all of them, at collection, never
    inside a tick."""
    kept = [(sp, k, v) for sp in spans for k, v in sp.attrs.items()
            if isinstance(v, torch.Tensor)]
    by_dev: dict = {}
    for item in kept:
        by_dev.setdefault(item[2].device, []).append(item)
    for items in by_dev.values():
        flat = torch.cat([v.reshape(-1).to(torch.int64)
                          for _, _, v in items]).cpu()
        at = 0
        for sp, k, v in items:
            n = v.numel()
            sp.attrs[k] = flat[at:at + n].reshape(v.shape).tolist()
            at += n


tracer = Tracer()
