"""spatten_tpu_torch: the PyTorch/CUDA port of spatten-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``spatten_tpu``.  Module names
mirror the JAX package (``ops/``, ``engine/``, ``models/``, ``pruning/``) so
each module's counterpart is easy to find.  Every Pallas TPU kernel on the
ported path is a hand-written CUDA C++ kernel under ``csrc/``, built with
``nvcc`` for ``sm_90a`` at first use; each kernel wrapper runs its plain
PyTorch version on CPU tensors (the tests) and the kernel on CUDA tensors.

The package imports ``torch`` and never ``jax`` or ``spatten_tpu``.
"""

__version__ = "0.1.0"

from spatten_tpu_torch.config import (
    EngineConfig,
    ModelConfig,
    PruningConfig,
    QuantConfig,
    SpAttenConfig,
)

__all__ = [
    "ModelConfig",
    "PruningConfig",
    "QuantConfig",
    "EngineConfig",
    "SpAttenConfig",
    "__version__",
]
