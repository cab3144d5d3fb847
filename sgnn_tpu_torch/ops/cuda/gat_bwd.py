"""Wrappers of K4, the attention backward's two passes (`csrc/gat_bwd.cu`).

`gat_bwd_src_cuda(ht, ts, gz, td, rz, rowptr_t, col_t, heads)` launches B1
over the transposed CSR and returns `(dht_agg [S, F], dts [S, H])`;
`gat_bwd_dst_cuda(ht, ts, gz, td, rz, rowptr, col, heads)` launches B2 over
the CSR and returns `dtd [D, H]`, all f32 (ops/gat.py has the function).
Both run on PyTorch's current stream, check device, dtype, contiguity and
shapes, and raise on anything the kernels do not take, heads wider than
256 columns included; index bounds are the caller's to check, once, on the
host.  B1 splits source rows longer than LONG_ROW_EDGES across warps
(`ops/segment.long_row_segments`).  Each wrapper's `.launches` counts its
calls that launch the kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..gat import check_gat_bwd_args
from ..segment import DTYPE_CODES, LONG_ROW_EDGES, long_row_segments
from .build import build

# the widest head the kernels take: 32 lanes x 8 columns (csrc/gat_bwd.cu)
MAX_HEAD_COLS = 256


@functools.lru_cache(maxsize=None)
def _entry():
    lib = build("gat_bwd").lib
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    src = lib.sgnn_gat_bwd_src
    src.argtypes = [ptr] * 12 + [i64, i64, i32, i64, i64, i32, ptr]
    src.restype = ctypes.c_int
    dst = lib.sgnn_gat_bwd_dst
    dst.argtypes = [ptr] * 8 + [i64, i64, i32, i32, ptr]
    dst.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return src, dst, err


def _check(name, ht, ts, gz, td, rz, rowptr, col, heads, rows_are_sources):
    if ht.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {ht.device}")
    check_gat_bwd_args(ht, ts, gz, td, rz, rowptr, col, heads,
                       rows_are_sources)
    if ht.shape[1] // heads > MAX_HEAD_COLS:
        raise ValueError(f"{name}: heads of {ht.shape[1] // heads} columns; "
                         f"the kernel takes at most {MAX_HEAD_COLS}")


def _raise(name, rc, err):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def gat_bwd_src_cuda(ht: torch.Tensor, ts: torch.Tensor, gz: torch.Tensor,
                     td: torch.Tensor, rz: torch.Tensor,
                     rowptr_t: torch.Tensor, col_t: torch.Tensor,
                     heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch B1 on CUDA tensors; raises on anything else."""
    _check("gat_bwd_src", ht, ts, gz, td, rz, rowptr_t, col_t, heads, True)
    num_rows, feat = ht.shape
    dht = torch.empty((num_rows, feat), dtype=torch.float32,
                      device=ht.device)
    dts = torch.empty((num_rows, heads), dtype=torch.float32,
                      device=ht.device)
    if num_rows == 0:
        return dht, dts
    src, _, err = _entry()
    with torch.cuda.device(ht.device):
        seg_ptr, max_seg = long_row_segments(rowptr_t, col_t.numel())
        part_dht = torch.empty((max_seg, feat), dtype=torch.float32,
                               device=ht.device)
        part_dts = torch.empty((max_seg, heads), dtype=torch.float32,
                               device=ht.device)
        stream = torch.cuda.current_stream(ht.device).cuda_stream
        rc = src(ht.data_ptr(), ts.data_ptr(), gz.data_ptr(), td.data_ptr(),
                 rz.data_ptr(), rowptr_t.data_ptr(), col_t.data_ptr(),
                 dht.data_ptr(), dts.data_ptr(), seg_ptr.data_ptr(),
                 part_dht.data_ptr(), part_dts.data_ptr(), num_rows, feat,
                 heads, LONG_ROW_EDGES, max_seg, DTYPE_CODES[ht.dtype],
                 stream)
    _raise("gat_bwd_src", rc, err)
    gat_bwd_src_cuda.launches += 1
    return dht, dts


def gat_bwd_dst_cuda(ht: torch.Tensor, ts: torch.Tensor, gz: torch.Tensor,
                     td: torch.Tensor, rz: torch.Tensor, rowptr: torch.Tensor,
                     col: torch.Tensor, heads: int) -> torch.Tensor:
    """Launch B2 on CUDA tensors; raises on anything else."""
    _check("gat_bwd_dst", ht, ts, gz, td, rz, rowptr, col, heads, False)
    num_rows, feat = gz.shape
    dtd = torch.empty((num_rows, heads), dtype=torch.float32,
                      device=ht.device)
    if num_rows == 0:
        return dtd
    _, dst, err = _entry()
    with torch.cuda.device(ht.device):
        stream = torch.cuda.current_stream(ht.device).cuda_stream
        rc = dst(ht.data_ptr(), ts.data_ptr(), gz.data_ptr(), td.data_ptr(),
                 rz.data_ptr(), rowptr.data_ptr(), col.data_ptr(),
                 dtd.data_ptr(), num_rows, feat, heads,
                 DTYPE_CODES[ht.dtype], stream)
    _raise("gat_bwd_dst", rc, err)
    gat_bwd_dst_cuda.launches += 1
    return dtd


gat_bwd_src_cuda.launches = 0
gat_bwd_dst_cuda.launches = 0
