"""Wrapper of the attention aggregation kernel K3 (`csrc/gat.cu`).

`gat_aggregate_cuda(ht, ts, td, rowptr, col, heads)` launches the kernel on
PyTorch's current stream and returns `(h, z)`: h [D, F] in ht's dtype, z
[D, heads] f32 (ops/gat.py has the function).  It checks device, dtype,
contiguity and shapes and raises on anything the kernel does not take;
index bounds are the caller's to check, once, on the host
(`ops/segment.csr_from_numpy`).  `gat_aggregate_cuda.launches` counts the
launches, so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..gat import check_gat_args
from ..segment import DTYPE_CODES
from .build import build


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build("gat").lib
    fn = lib.sgnn_gat_aggregate
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def gat_aggregate_cuda(ht: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                       rowptr: torch.Tensor, col: torch.Tensor,
                       heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors; raises on anything else."""
    if ht.device.type != "cuda":
        raise ValueError(f"gat_aggregate_cuda takes CUDA tensors, got "
                         f"{ht.device}")
    check_gat_args(ht, ts, td, rowptr, col, heads)
    num_rows, feat = rowptr.numel() - 1, ht.shape[1]
    out = torch.empty((num_rows, feat), dtype=ht.dtype, device=ht.device)
    z = torch.empty((num_rows, heads), dtype=torch.float32, device=ht.device)
    if num_rows == 0:
        return out, z
    fn, err = _entry()
    with torch.cuda.device(ht.device):
        stream = torch.cuda.current_stream(ht.device).cuda_stream
        rc = fn(ht.data_ptr(), ts.data_ptr(), td.data_ptr(),
                rowptr.data_ptr(), col.data_ptr(), out.data_ptr(),
                z.data_ptr(), num_rows, feat, heads, DTYPE_CODES[ht.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"gat_aggregate kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    gat_aggregate_cuda.launches += 1
    return out, z


gat_aggregate_cuda.launches = 0
