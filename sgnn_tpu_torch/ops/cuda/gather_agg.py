"""Wrappers of the K1 kernels (`csrc/gather_agg.cu`).

Three entry points, each launching one kernel on PyTorch's current stream:

- `gather_agg_fwd_cuda(x, nbr, w)`      → out [D, F] in x's dtype;
- `gather_agg_bwd_dx_cuda(g, nbr, w, x)` → dx [S, F] in x's dtype, summed
  by f32 atomics into a zeroed f32 buffer (not bit-deterministic);
- `gather_agg_bwd_dw_cuda(g, x, nbr)`    → dw [D, K] f32.

Each checks device, dtype, contiguity and shapes and raises on anything
the kernel does not take; index bounds are the caller's (see
`ops/aggregate.check_block_args`).  Each has a `.launches` counter, raised
by one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..aggregate import check_block_args, check_grad_arg
from ..segment import SPMM_DTYPES
from .build import build

_DTYPE_CODES = {dt: code for code, dt in enumerate(SPMM_DTYPES)}
_P = ctypes.c_void_p
_ARGS = {
    "sgnn_gather_agg_fwd": [_P] * 4,
    "sgnn_gather_agg_bwd_dx": [_P] * 4,
    "sgnn_gather_agg_bwd_dw": [_P] * 4,
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = build("gather_agg").lib
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name] + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int, _P]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(name: str, ptrs, x: torch.Tensor, num_dst: int, k_slots: int,
            feat: int) -> None:
    fn, err = _entry(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*ptrs, num_dst, k_slots, feat, _DTYPE_CODES[x.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _require_cuda(x: torch.Tensor, who: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {x.device}")


def gather_agg_fwd_cuda(x: torch.Tensor, nbr: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """out[d] = Σ_k w[d,k]·x[nbr[d,k]] on the card."""
    _require_cuda(x, "gather_agg_fwd_cuda")
    check_block_args(x, nbr, w)
    (d, k), feat = nbr.shape, x.shape[1]
    if d == 0 or feat == 0 or k == 0:
        return torch.zeros((d, feat), dtype=x.dtype, device=x.device)
    out = torch.empty((d, feat), dtype=x.dtype, device=x.device)
    _launch("sgnn_gather_agg_fwd",
            (x.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr()),
            x, d, k, feat)
    gather_agg_fwd_cuda.launches += 1
    return out


def gather_agg_bwd_dx_cuda(g: torch.Tensor, nbr: torch.Tensor,
                           w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dx[s] = Σ_{nbr[d,k]=s} w[d,k]·g[d] on the card, by f32 atomics: the
    order of the adds into one source row changes from run to run."""
    _require_cuda(x, "gather_agg_bwd_dx_cuda")
    check_block_args(x, nbr, w)
    check_grad_arg(g, x, nbr)
    (d, k), (s, feat) = nbr.shape, x.shape
    dx = torch.zeros((s, feat), dtype=torch.float32, device=x.device)
    if d and k and feat:
        _launch("sgnn_gather_agg_bwd_dx",
                (g.data_ptr(), nbr.data_ptr(), w.data_ptr(), dx.data_ptr()),
                x, d, k, feat)
        gather_agg_bwd_dx_cuda.launches += 1
    return dx.to(x.dtype)


def gather_agg_bwd_dw_cuda(g: torch.Tensor, x: torch.Tensor,
                           nbr: torch.Tensor) -> torch.Tensor:
    """dw[d,k] = <g[d], x[nbr[d,k]]> on the card, f32 [D, K]."""
    _require_cuda(x, "gather_agg_bwd_dw_cuda")
    check_block_args(x, nbr)
    check_grad_arg(g, x, nbr)
    (d, k), feat = nbr.shape, x.shape[1]
    if d == 0 or k == 0 or feat == 0:
        return torch.zeros((d, k), dtype=torch.float32, device=x.device)
    dw = torch.empty((d, k), dtype=torch.float32, device=x.device)
    _launch("sgnn_gather_agg_bwd_dw",
            (g.data_ptr(), x.data_ptr(), nbr.data_ptr(), dw.data_ptr()),
            x, d, k, feat)
    gather_agg_bwd_dw_cuda.launches += 1
    return dw


gather_agg_fwd_cuda.launches = 0
gather_agg_bwd_dx_cuda.launches = 0
gather_agg_bwd_dw_cuda.launches = 0
