"""Build and load the native sampler library (g++ -O3 -fopenmp).

Compiled at first use into `build/native/` at the root of the checkout,
named by a hash of the source and the flags, so an unchanged source is not
compiled again; concurrent builders each write a private temporary file
and rename it into place.  A failed build raises RuntimeError with g++'s
output: the port never switches quietly to the numpy sampler, whose draws
differ.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-fopenmp")


def build_library() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    out = BUILD_DIR / f"libsgnn_sampler-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError("the native sampler needs g++ to build") from exc
    if proc.returncode != 0:
        raise RuntimeError("g++ failed to build the native sampler:\n"
                           + proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The loaded library with every entry point's argtypes declared."""
    lib = ctypes.CDLL(str(build_library()))
    c_i64, c_u64, c_i32 = ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_u64 = ctypes.POINTER(ctypes.c_uint64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_f32 = ctypes.POINTER(ctypes.c_float)
    sigs = {
        "sgnn_sample_hop": ([p_i64, p_i32, c_i64, p_i32, c_i64, c_i32, p_i32,
                             c_u64, p_i32, p_u8, p_u64], None),
        "sgnn_bitmap_add": ([p_u64, p_i32, c_i64], None),
        "sgnn_collect_srcs": ([p_u64, c_i64, p_i32, p_i32], c_i64),
        "sgnn_reindex": ([p_i32, p_u8, c_i64, p_i32, p_i32], None),
        "sgnn_weights": ([p_i32, p_u8, c_i64, c_i32, c_i64, p_i32, p_i32,
                          p_i32, p_i32, c_i32, p_f32], None),
        "sgnn_num_threads": ([], ctypes.c_int),
        "sgnn_gather_rows": ([p_u8, c_i64, p_i32, c_i64, p_u8, p_u8], None),
        "sgnn_csc_build": ([p_i32, c_i64, c_i64, p_i64, p_i32, p_i32], None),
        "sgnn_stable_argsort": ([p_i32, c_i64, c_i64, p_i32], None),
        "sgnn_csc_transpose": ([p_i64, p_i32, c_i64, c_i64, p_i64, p_i32],
                               None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib
