"""The launch probe's plain versions (P1-P5) vs numpy renderings of the
Pallas bodies' arithmetic, on the CPU, exact.

The JAX probes are closures inside ``tools/pallas_overhead.py::main``
that run only on TPU memory spaces (``pltpu.ANY``, VMEM scratch, DMA
semaphores), so they can be neither imported nor run here; the numpy
below repeats what their bodies compute: ``k_add`` (o = x + 1), ``k_dma``
(o = f32 sum of rows 0-255 broadcast), ``k_alias`` (rows 0-7 + 1 through
int32, cast back to int8, o = 0) and ``k_sp`` (o = x + s[0]).  The
kernels themselves are held against these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from spatten_tpu_torch.tools import launch_overhead as lo


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_body(pid, x, plane, s):
    """(o, plane after) of the Pallas body, in numpy."""
    plane = plane.copy()
    if pid in ("P1", "P2"):
        return x + np.float32(1.0), plane
    if pid == "P3":
        return np.full(lo.BLOCK, plane[:256].astype(np.float32).sum(),
                       np.float32), plane
    if pid == "P4":
        plane[:8] = (plane[:8].astype(np.int32) + 1).astype(np.int8)
        return np.zeros(lo.BLOCK, np.float32), plane
    return x + s[0].astype(np.float32), plane


@pytest.mark.parametrize("pid", list(lo.PROBES))
def test_probe_plain_matches_pallas_body(pid):
    ops = lo.inputs("cpu", seed=1)
    # extremes: P4 wraps 127 -> -128, P3's sum reaches its range
    ops["plane"][:8, :4] = 127
    ops["plane"][8:256] = -128
    ops["s"][0] = 3
    x, plane, s = (ops[k].numpy().copy() for k in ("x", "plane", "s"))
    kern, plain, replaces, _ = lo.PROBES[pid]
    assert replaces.startswith("tools/pallas_overhead.py:")
    got = kern(*lo.args_of(pid, ops))          # CPU tensors: the plain one
    want, plane_after = numpy_body(pid, x, plane, s)
    assert got.dtype == torch.float32 and tuple(got.shape) == lo.BLOCK
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ops["plane"].numpy(), plane_after)
    assert kern.launches == 0                  # no kernel ran on the CPU


def test_probe_module_imports_and_harness_needs_the_card(monkeypatch):
    assert set(lo.PROBES) == {"P1", "P2", "P3", "P4", "P5"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        lo.eager_us(lambda: None)
    with pytest.raises(RuntimeError):
        lo.measure(lo.inputs("cpu"))
