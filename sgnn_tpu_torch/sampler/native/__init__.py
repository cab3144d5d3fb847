"""Native (C++/OpenMP) host sampler backend, the port's own copy.

`sampler.cpp` is built with g++ at first use into `build/native/`
(build.py); `sample_batch`, `gather_rows`, `build_csc`, `stable_argsort`
and `transpose_csc` drive it through ctypes (bindings.py).  Each raises
when g++ cannot build the library: there is no numpy fallback.
Reference analog: FastSampler's OpenMP hop loop
(core/ntsFastSampler.hpp:962).
"""

from .bindings import (
    build_csc, gather_rows, sample_batch, stable_argsort, transpose_csc,
)
from .build import load_library

__all__ = ["build_csc", "gather_rows", "load_library", "sample_batch",
           "stable_argsort", "transpose_csc"]
