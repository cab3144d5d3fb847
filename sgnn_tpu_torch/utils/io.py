"""Bulk array reads: one read() + frombuffer instead of numpy's file loop."""

from __future__ import annotations

import numpy as np


def read_binary(path: str, dtype) -> np.ndarray:
    """Whole-file typed read via one read() + frombuffer (writable copy)."""
    with open(path, "rb") as f:
        buf = f.read()
    return np.frombuffer(bytearray(buf), dtype=dtype)
