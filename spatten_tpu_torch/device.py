"""Device selection for the port's public entry points.

Entry points default to ``device="cuda"`` and raise when CUDA is missing:
the CPU runs only when a caller asks for it (``device="cpu"``), as the
tests do.  There is no silent CPU fallback.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is a CUDA
    device and CUDA is unavailable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
