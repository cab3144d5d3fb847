"""Leveled logging on Python's stdlib logging (the reference's LOG_* levels)."""

from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s %(filename)s:%(lineno)d] %(message)s"


def get_logger(name: str = "sgnn") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("SGNN_LOG_LEVEL", "INFO").upper())
        logger.propagate = False
    return logger
