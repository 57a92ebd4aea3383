"""Structured logging for the engine (port of
``spatten_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging
import sys


def get_logger(name: str = "spatten_tpu_torch") -> logging.Logger:
    """A logger writing ``time name level message`` lines to stderr (one
    handler per name, INFO by default)."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger
