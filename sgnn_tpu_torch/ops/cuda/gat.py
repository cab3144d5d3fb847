"""Wrapper of the attention aggregation kernel K3 (`csrc/gat.cu`).

`gat_aggregate_cuda(ht, ts, td, rowptr, col, heads)` launches the kernel on
PyTorch's current stream and returns `(h, z)`: h [D, F] in ht's dtype, z
[D, heads] f32 (ops/gat.py has the function).  It checks device, dtype,
contiguity and shapes and raises on anything the kernel does not take;
index bounds are the caller's to check, once, on the host
(`ops/segment.csr_from_numpy`).  `gat_aggregate_cuda.launches` counts the
launches, so a run can show that its path went through the kernel.
`vector_columns(ht, heads)` says whether a call takes the kernel's vector
columns (4 adjacent columns a lane in one load) or its scalar ones.
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
    # ht, ts, td, rowptr, col, out, z; num_rows, feat; heads, vec, dtype;
    # stream
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def vector_columns(ht: torch.Tensor, heads: int) -> bool:
    """Whether K3 loads 4 adjacent columns a lane as one 16-byte (f32) or
    8-byte (bf16) vector: F and F / heads multiples of 4 and ht 16-byte
    aligned (F = 128 rows); else one column a load (F = 41)."""
    feat = ht.shape[1]
    return (feat % 4 == 0 and (feat // heads) % 4 == 0
            and ht.data_ptr() % 16 == 0)


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
                z.data_ptr(), num_rows, feat, heads,
                int(vector_columns(ht, heads)), DTYPE_CODES[ht.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"gat_aggregate kernel launch failed: CUDA error "
                           f"{rc} ({err(rc).decode()})")
    gat_aggregate_cuda.launches += 1
    return out, z


gat_aggregate_cuda.launches = 0
