"""Shared utilities: profiling and tracing hooks, structured logging, and
the opt-in numeric checks of ``debug``."""

from spatten_tpu_torch.utils.logging import get_logger
from spatten_tpu_torch.utils.profiling import annotate, profile_trace

__all__ = ["profile_trace", "annotate", "get_logger"]
