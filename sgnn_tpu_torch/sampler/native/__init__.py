"""Native (C++/OpenMP) host sampler backend, the port's own copy.

`sampler.cpp` is built with g++ at first use into `build/native/`
(build.py); `sample_batch`, `gather_rows` and `build_csc` drive it through
ctypes (bindings.py).  Reference analog: FastSampler's OpenMP hop loop
(core/ntsFastSampler.hpp:962).
"""

from .bindings import build_csc, gather_rows, sample_batch
from .build import load_library

__all__ = ["build_csc", "gather_rows", "load_library", "sample_batch"]
