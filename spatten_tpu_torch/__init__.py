"""spatten_tpu_torch: the PyTorch/CUDA port of spatten-tpu for NVIDIA Hopper.

A second package beside the JAX reference ``spatten_tpu``.  Module names
mirror the JAX package (``ops/``, ``engine/``, ``models/``, ``pruning/``,
``parallel/``, ``utils/``, ``eval/``, ``perf/``) so each module's
counterpart is easy to find; ``run_spatten_gpu.py`` at the repository
root is the counterpart of the JAX CLI.  Every Pallas TPU kernel on the
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
