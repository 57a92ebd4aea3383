"""Plain and weight-only-int8 matrix helpers (port of
``spatten_tpu/models/weight_quant.py``).

A quantized matrix is a dict ``{"qw": int8, "ws": f32 scale}`` with one
scale per output channel; ``matmul`` dispatches on the leaf type so the
transformer consumes either representation.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_LAYER_CONTRACT_AXIS = {
    "wq": 1, "wk": 1, "wv": 1, "wo": 1,
    "w_gate": 1, "w_up": 1, "w_down": 1,
}


def _quant_matrix(w: torch.Tensor, axis: int) -> Dict[str, torch.Tensor]:
    w32 = w.to(torch.float32)
    amax = w32.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    qw = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"qw": qw, "ws": scale.squeeze(axis)}


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize every matmul weight of an ``init_params`` tree."""
    out = dict(params)
    layers = dict(params["layers"])
    for name, axis in _LAYER_CONTRACT_AXIS.items():
        if name in layers:
            layers[name] = _quant_matrix(layers[name], axis)
    out["layers"] = layers
    out["embed"] = _quant_matrix(params["embed"], axis=1)
    if "lm_head" in params:
        out["lm_head"] = _quant_matrix(params["lm_head"], axis=0)
    if "wpe" in params:
        out["wpe"] = _quant_matrix(params["wpe"], axis=1)
    return out


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "qw" in w


def matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w for a plain tensor or a quantized {"qw","ws"} matrix."""
    if is_quantized(w):
        y = torch.matmul(x, w["qw"].to(x.dtype))
        return (y.to(torch.float32) * w["ws"]).to(x.dtype)
    return torch.matmul(x, w)


def matmul_t(x: torch.Tensor, w) -> torch.Tensor:
    """x @ w.T (tied lm_head): output channels are w's rows."""
    if is_quantized(w):
        y = torch.matmul(x, w["qw"].T.to(x.dtype))
        return (y.to(torch.float32) * w["ws"]).to(x.dtype)
    return torch.matmul(x, w.T)


def take_rows(w, idx: torch.Tensor) -> torch.Tensor:
    """Row lookup (embedding / positional tables)."""
    if is_quantized(w):
        rows = w["qw"][idx].to(torch.float32)
        return rows * w["ws"][idx][..., None]
    return w[idx]
