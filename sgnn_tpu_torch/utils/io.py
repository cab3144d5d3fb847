"""Bulk array reads and writes (from sgnn_tpu/utils/io.py): one read() +
frombuffer, or one header write + one buffer write, instead of numpy's
per-chunk file loops (`read_binary`, `save_npy`, `load_npy`)."""

from __future__ import annotations

import numpy as np


def read_binary(path: str, dtype) -> np.ndarray:
    """Whole-file typed read via one read() + frombuffer (writable copy)."""
    with open(path, "rb") as f:
        buf = f.read()
    return np.frombuffer(bytearray(buf), dtype=dtype)


def save_npy(path: str, arr: np.ndarray) -> None:
    """np.save equivalent that bypasses arr.tofile's slow write loop."""
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(arr))
        f.write(arr.tobytes())


def load_npy(path: str) -> np.ndarray:
    """np.load equivalent via one read() + frombuffer (a writable array);
    object arrays and unknown format versions go through np.load."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        elif version == (2, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        else:
            return np.load(path)
        if dtype.hasobject:
            return np.load(path, allow_pickle=True)
        buf = f.read()
    a = np.frombuffer(bytearray(buf), dtype=dtype, count=int(np.prod(shape)))
    return a.reshape(shape, order="F" if fortran else "C")
