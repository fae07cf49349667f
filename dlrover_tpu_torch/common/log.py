"""Shared logger — a copy of dlrover_tpu/common/log.py (reference
parity: dlrover/python/common/log.py) under the port's logger name."""

import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] "
    "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s"
)


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("dlrover_tpu_torch")
    if logger.handlers:
        return logger
    level = os.environ.get("DLROVER_TPU_LOG_LEVEL", "INFO").upper()
    logger.setLevel(getattr(logging, level, logging.INFO))
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()
