"""Opt-in numeric checks (port of ``spatten_tpu/utils/debug.py``).

The failure modes worth trapping are numeric (a NaN escaping a masked
region, a zero softmax denominator) and consistency (a tensor that should
be identical on every device or shard diverging).  Three hooks, all
opt-in:

* ``debug_mode()`` -- a scope in which the first op whose floating output
  holds a NaN raises, naming the op (the counterpart of
  ``jax_debug_nans``);
* ``checkify_step(fn, *args)`` -- run one step under the checks of JAX's
  ``checkify.float_checks``: a NaN produced by an op, a division by zero;
* ``replicated_mismatch(copies)`` -- the max abs difference over copies of
  a tensor that should hold the same bytes (0.0 == consistent).

``SPATTEN_DEBUG=1`` makes ``engine.generate.generate`` run the first
prefill chunk under ``checkify_step`` (once per call), so numeric
corruption raises at its source instead of surfacing as garbage tokens.

The checks are a ``TorchDispatchMode``: every op that runs inside them is
followed by a scan of its outputs (on the card, a synchronising read per
op), so they are for debugging, not for serving.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# ops whose divisor (second argument; the input of a reciprocal) must not
# hold a zero under checkify_step, as JAX's div_checks require of div
_DIVISIONS = {"div", "div_", "floor_divide", "floor_divide_", "reciprocal",
              "reciprocal_"}


# ops that allocate without writing values (whatever bytes they hold are
# not a NaN that an op produced)
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
                "new_empty_strided", "empty_permuted"}


def enabled() -> bool:
    """True when SPATTEN_DEBUG is set (the engine's hooks check this)."""
    return bool(os.environ.get("SPATTEN_DEBUG"))


def _has_nan(x: Any) -> bool:
    return (isinstance(x, torch.Tensor) and x.is_floating_point()
            and bool(torch.isnan(x).any()))


class _FloatChecks(TorchDispatchMode):
    """Raises FloatingPointError at the first op that produces a NaN
    (and, with ``div``, at the first division by a tensor holding 0)."""

    def __init__(self, div: bool):
        super().__init__()
        self.div = div

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if self.div and name in _DIVISIONS:
            divisor = args[0] if name.startswith("reciprocal") else args[1]
            if isinstance(divisor, torch.Tensor):
                zero = bool((divisor == 0).any())
            else:
                zero = divisor == 0
            if zero:
                raise FloatingPointError(f"division by zero in {func}")
        out = func(*args, **kwargs)
        if name not in _ALLOCATIONS and any(
                _has_nan(x) for x in tree_leaves(out)):
            raise FloatingPointError(f"nan generated by op {func}")
        return out


@contextlib.contextmanager
def debug_mode(nans: bool = True):
    """Scope in which the first op whose floating output holds a NaN raises
    FloatingPointError naming the op (``nans=False``: no checks)."""
    if not nans:
        yield
        return
    with _FloatChecks(div=False):
        yield


def checkify_step(fn: Callable, *args, **kwargs) -> Any:
    """Run ``fn(*args, **kwargs)`` under the checks of JAX's
    ``checkify.float_checks``: FloatingPointError ("nan generated by op
    ...") at the first op that produces a NaN, or ("division by zero in
    ...") at the first division by a tensor holding 0; returns fn's
    result otherwise.  Work outside PyTorch's ops (a kernel launched
    through ``kernels.launch``) is not inspected, only the ops around it."""
    with _FloatChecks(div=True):
        return fn(*args, **kwargs)


def replicated_mismatch(copies: Sequence[torch.Tensor]) -> float:
    """Max abs difference between copies of a tensor that should hold the
    same bytes (one per device, rank or shard), read on the host in f64.
    0.0 means every copy is identical -- the consistency invariant of
    replicated state (lengths, head masks, requant counters); a nonzero
    value is the collective analog of a data race.  ValueError when the
    copies' shapes differ."""
    copies = list(copies)
    if len(copies) <= 1:
        return 0.0
    base = copies[0].detach().to("cpu", torch.float64)
    worst = 0.0
    for c in copies[1:]:
        x = c.detach().to("cpu", torch.float64)
        if x.shape != base.shape:
            raise ValueError(f"copies of shapes {tuple(base.shape)} and "
                             f"{tuple(x.shape)} are not replicas")
        if base.numel():
            worst = max(worst, float((x - base).abs().max()))
    return worst
