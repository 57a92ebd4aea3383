"""Profiling and tracing hooks (port of ``spatten_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace of host activity and,
where a CUDA device is present, of the card's kernels (CUPTI), and writes
it as a Chrome trace (``chrome://tracing`` or Perfetto) into a directory;
``annotate`` names a region of that timeline."""

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
