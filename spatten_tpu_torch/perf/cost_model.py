"""Roofline cost model over workload traces (port of
``spatten_tpu/perf/cost_model.py``).

``estimate_cost`` prices a trace (``engine.trace.TraceRow`` rows) through
the repository's ``native/libspatten_cost.so`` (``native/
spatten_cost.cpp``, loaded with ctypes), or through a numpy version with
the same semantics where the library cannot load.  Each iteration costs
the larger of its bytes over the memory rate and its operations over the
peak rate, plus a fixed per-step overhead.

The preset, ``H100_SXM``, describes one NVIDIA H100 SXM card; callers
comparing with the JAX package pass ``HwParams`` explicitly.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libspatten_cost.so")

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


@dataclass(frozen=True)
class HwParams:
    """Card parameters for the roofline.  The defaults are one card that
    reads ``NVIDIA H100 80GB HBM3, 700.00 W`` (``nvidia-smi --query-gpu=
    name,power.limit``)."""

    # NVIDIA H100 80GB HBM3, 700.00 W: HBM3 at 3.35 TB/s (data sheet)
    hbm_gbps: float = 3350.0
    # NVIDIA H100 80GB HBM3, 700.00 W: dense bf16 tensor-core peak, 989
    # TFLOP/s (data sheet)
    peak_tflops: float = 989.0
    # NVIDIA H100 80GB HBM3, 700.00 W: host time per eager decode step
    # beyond the device's, at Llama-2-7B width under the serving
    # configuration: chip_smoke.py's serving path, host-clock 35.729
    # ms/step minus its profiled device 10.957 ms/step (that script's
    # "cost model step overhead" line; the host clock moves a step by up
    # to 1.6x between runs)
    step_overhead_us: float = 24_771.7
    weight_bytes_per_step: float = 0.0
    scale_bytes_per_elem: float = 4.0  # f32 per-token scale
    requant_refetch_factor: float = 2.0  # int8 full / 4-bit msb


H100_SXM = HwParams()


@dataclass
class CostResult:
    total_bytes: float
    total_flops: float
    total_seconds: float
    tokens_per_s: float
    iterations: int


class _CHw(ctypes.Structure):
    _fields_ = [("hbm_gbps", ctypes.c_double),
                ("peak_tflops", ctypes.c_double),
                ("step_overhead_us", ctypes.c_double),
                ("weight_bytes_per_step", ctypes.c_double),
                ("scale_bytes_per_elem", ctypes.c_double),
                ("requant_refetch_factor", ctypes.c_double)]


class _CCost(ctypes.Structure):
    _fields_ = [("total_bytes", ctypes.c_double),
                ("total_flops", ctypes.c_double),
                ("total_seconds", ctypes.c_double),
                ("tokens_per_s", ctypes.c_double),
                ("iterations", ctypes.c_int64)]


def _load_lib() -> Optional[ctypes.CDLL]:
    """The native library, or None where it is missing or does not load
    (then the numpy version prices the trace)."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.spatten_cost_model.restype = None
        lib.spatten_dense_bytes.restype = None
        _lib = lib
    except OSError:
        return None
    return _lib


def _columns(rows: Sequence) -> dict:
    return {
        "iteration_id": np.array(
            [r.iteration_id for r in rows], np.int64),
        "key_fetch": np.array([r.key_fetch_num for r in rows], np.int64),
        "val_fetch": np.array([r.value_fetch_num for r in rows], np.int64),
        "kbit": np.array([r.quant_key_bit for r in rows], np.int64),
        "vbit": np.array([r.quant_value_bit for r in rows], np.int64),
        "if_requant": np.array([r.if_requant for r in rows], np.uint8),
        "head_dim": np.array(
            [r.embedding_length_D for r in rows], np.float64),
        "sentence_len": np.array(
            [r.sentence_length_L for r in rows], np.int64),
    }


def estimate_cost(rows: Sequence, hw: HwParams = H100_SXM) -> CostResult:
    """Price a workload trace (list of TraceRow) on ``hw``."""
    if len(rows) == 0:
        return CostResult(0.0, 0.0, 0.0, 0.0, 0)
    c = _columns(rows)
    lib = _load_lib()
    if lib is None:
        return _estimate_numpy(c, hw)
    chw = _CHw(hw.hbm_gbps, hw.peak_tflops, hw.step_overhead_us,
               hw.weight_bytes_per_step, hw.scale_bytes_per_elem,
               hw.requant_refetch_factor)
    cost = _CCost()

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.spatten_cost_model(
        p(c["iteration_id"]), p(c["key_fetch"]), p(c["val_fetch"]),
        p(c["kbit"]), p(c["vbit"]),
        c["if_requant"].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        c["head_dim"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(rows)), ctypes.byref(chw), ctypes.byref(cost))
    return CostResult(cost.total_bytes, cost.total_flops,
                      cost.total_seconds, cost.tokens_per_s,
                      int(cost.iterations))


def _estimate_numpy(c: dict, hw: HwParams) -> CostResult:
    kb = np.where(c["kbit"] < 0, 16.0, c["kbit"].astype(np.float64))
    vb = np.where(c["vbit"] < 0, 16.0, c["vbit"].astype(np.float64))
    D = c["head_dim"]
    key_bytes = c["key_fetch"] * D * kb / 8.0 + \
        c["key_fetch"] * hw.scale_bytes_per_elem
    key_bytes = np.where(c["if_requant"] > 0,
                         key_bytes * (1.0 + hw.requant_refetch_factor),
                         key_bytes)
    val_bytes = c["val_fetch"] * D * vb / 8.0 + \
        c["val_fetch"] * hw.scale_bytes_per_elem
    row_bytes = key_bytes + val_bytes
    flops = 2.0 * (c["key_fetch"] + c["val_fetch"]) * D
    flops = flops + np.where(c["if_requant"] > 0,
                             2.0 * c["key_fetch"] * D, 0.0)

    it = c["iteration_id"]
    # group contiguous runs of equal iteration ids (CSV order)
    change = np.flatnonzero(np.diff(it) != 0) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [len(it)]])
    total_seconds = 0.0
    cs_b = np.concatenate([[0.0], np.cumsum(row_bytes)])
    cs_f = np.concatenate([[0.0], np.cumsum(flops)])
    for s, e in zip(starts, ends):
        bts = cs_b[e] - cs_b[s] + hw.weight_bytes_per_step
        fl = cs_f[e] - cs_f[s]
        total_seconds += max(bts / (hw.hbm_gbps * 1e9),
                             fl / (hw.peak_tflops * 1e12)) \
            + hw.step_overhead_us * 1e-6
    n_iter = len(starts)
    return CostResult(
        total_bytes=float(row_bytes.sum() +
                          hw.weight_bytes_per_step * n_iter),
        total_flops=float(flops.sum()),
        total_seconds=float(total_seconds),
        tokens_per_s=float(n_iter / total_seconds) if total_seconds else 0.0,
        iterations=n_iter,
    )


def dense_bytes(rows: Sequence) -> float:
    """Memory bytes of the dense fp16 run of the same trace (K and V per
    request): the denominator of SpAtten's DRAM-access reduction."""
    if len(rows) == 0:
        return 0.0
    c = _columns(rows)
    lib = _load_lib()
    if lib is None:
        return float((2.0 * c["sentence_len"] * c["head_dim"] * 2.0).sum())
    out = ctypes.c_double()
    lib.spatten_dense_bytes(
        c["iteration_id"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        c["sentence_len"].ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        c["head_dim"].ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.c_int64(len(c["sentence_len"])), ctypes.byref(out))
    return out.value
