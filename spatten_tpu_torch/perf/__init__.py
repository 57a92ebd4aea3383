"""Performance subsystem: the roofline cost model over workload traces
(native C++ through ctypes, or numpy), priced on this card's preset."""

from spatten_tpu_torch.perf.cost_model import (
    H100_SXM,
    CostResult,
    HwParams,
    dense_bytes,
    estimate_cost,
)

__all__ = ["HwParams", "CostResult", "estimate_cost", "dense_bytes",
           "H100_SXM"]
