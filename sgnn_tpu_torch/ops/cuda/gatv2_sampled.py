"""Wrappers of the sampled GATv2 layer's kernels (`csrc/gatv2_sampled.cu`).

- `gatv2_sampled_fwd_cuda(xl, xr, att, nbr, w, heads)` → `(out [D, F],
  alpha [D, K, H])`: one launch, a warp a destination row, an online
  softmax a head;
- `gatv2_sampled_bwd_cuda(g, xl, xr, att, nbr, w, alpha, heads)` → `(dxl
  [S, F], dxr [D, F], datt [F])`: the destination pass (dscore [D, K, H],
  dxr, att's gradient as partial rows of at most DST_BLOCKS blocks,
  summed in block order), the block's transpose keyed by source with its
  slots (`gather_agg.transpose_slots`, K1 dx's radix passes), then
  csr_sum.cuh's walk over it (dxl, hub sources in pieces).  No float
  atomics: bit-identical from run to run.

ops/gatv2_sampled.py has the function.  Both run on PyTorch's current
stream, take f32 tensors, check device, dtype, contiguity and shapes and
raise on anything the kernels do not take (a head of more than 512
columns, 128 where its columns are not loaded four at a time; F past
1536); index bounds are the caller's (the sampler's, by construction).
Each has a `.launches` counter, raised by one where it launches its
kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..gatv2_sampled import check_gatv2_sampled_args, check_gatv2_sampled_grad
from ..segment import csr_chunk_edges
from . import gather_agg
from .build import build_all

_P = ctypes.c_void_p
_I64, _I32 = ctypes.c_longlong, ctypes.c_int
_ARGS = {
    # xl, xr, att, nbr, w, out, alpha; num_dst, k, feat, heads, vec
    "sgnn_gatv2_sampled_fwd": [_P] * 7 + [_I64, _I32, _I64, _I32, _I32, _P],
    # g, xl, xr, att, nbr, w, alpha, dscore, dxr, part, datt; num_dst, k,
    # feat, heads, vec, max_blocks
    "sgnn_gatv2_sampled_bwd_dst": [_P] * 11 + [_I64, _I32, _I64, _I32, _I32,
                                               _I64, _P],
    # g, xl, xr, att, alpha, dscore, rowptr_t, slot_t, dxl, carry,
    # carry_row; num_src, max_edges, chunk, feat; heads, k, vec
    "sgnn_gatv2_sampled_bwd_src": [_P] * 11 + [_I64] * 4 + [_I32] * 3 + [_P],
}
# the destination pass's largest grid: att's gradient is summed from at
# most this many partial rows, fixed by D alone
DST_BLOCKS = 1024
# a destination-pass block's shared rows of att's gradient
MAX_FEAT = 1536


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    # the backward's transposes are K1's: both libraries' nvcc at once
    lib = build_all(["gatv2_sampled", "gather_agg"])["gatv2_sampled"].lib
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _call(name: str, *args) -> None:
    fn, err = _entry(name)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def columns_a_load(feat: int, heads: int, *rows: torch.Tensor) -> int:
    """4 where a head's columns and every row are 16-byte aligned, else 1;
    ValueError for a head the kernels' lanes cannot hold."""
    c = feat // heads
    vec = 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in rows) else 1
    if c > 32 * vec * 4 or feat > MAX_FEAT:
        raise ValueError(f"gatv2_sampled on the card takes heads of at most "
                         f"{32 * vec * 4} columns and F <= {MAX_FEAT}, got "
                         f"{heads} heads of {c}")
    return vec


def _require_cuda(x: torch.Tensor, who: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {x.device}")


def gatv2_sampled_fwd_cuda(xl: torch.Tensor, xr: torch.Tensor,
                           att: torch.Tensor, nbr: torch.Tensor,
                           w: torch.Tensor, heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the card: `(out, alpha)`."""
    _require_cuda(xl, "gatv2_sampled_fwd_cuda")
    check_gatv2_sampled_args(xl, xr, att, nbr, w, heads)
    (d, k), (s, feat) = nbr.shape, xl.shape
    if not (d and k and s):
        return (torch.zeros((d, feat), dtype=xl.dtype, device=xl.device),
                torch.zeros((d, k, heads), dtype=xl.dtype, device=xl.device))
    # every element of both is written by the kernel
    out = torch.empty((d, feat), dtype=xl.dtype, device=xl.device)
    alpha = torch.empty((d, k, heads), dtype=xl.dtype, device=xl.device)
    vec = columns_a_load(feat, heads, xl, xr, att, out)
    with torch.cuda.device(xl.device):
        stream = torch.cuda.current_stream(xl.device).cuda_stream
        _call("sgnn_gatv2_sampled_fwd", xl.data_ptr(), xr.data_ptr(),
              att.data_ptr(), nbr.data_ptr(), w.data_ptr(), out.data_ptr(),
              alpha.data_ptr(), d, k, feat, heads, vec, stream)
    gatv2_sampled_fwd_cuda.launches += 1
    return out, alpha


def gatv2_sampled_bwd_cuda(g: torch.Tensor, xl: torch.Tensor,
                           xr: torch.Tensor, att: torch.Tensor,
                           nbr: torch.Tensor, w: torch.Tensor,
                           alpha: torch.Tensor, heads: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The backward on the card: `(dxl, dxr, datt)`."""
    _require_cuda(xl, "gatv2_sampled_bwd_cuda")
    check_gatv2_sampled_args(xl, xr, att, nbr, w, heads)
    check_gatv2_sampled_grad(g, alpha, xl, nbr, heads)
    (d, k), (s, feat) = nbr.shape, xl.shape
    dev = xl.device
    if not (d and k and s):
        return (torch.zeros_like(xl), torch.zeros_like(xr),
                torch.zeros_like(att))
    dscore = torch.empty((d, k, heads), dtype=torch.float32, device=dev)
    dxr = torch.empty((d, feat), dtype=torch.float32, device=dev)
    part = torch.empty((DST_BLOCKS, feat), dtype=torch.float32, device=dev)
    datt = torch.empty(feat, dtype=torch.float32, device=dev)
    dxl = torch.empty((s, feat), dtype=torch.float32, device=dev)
    vec = columns_a_load(feat, heads, g, xl, xr, att, dxr, dxl)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("sgnn_gatv2_sampled_bwd_dst", g.data_ptr(), xl.data_ptr(),
              xr.data_ptr(), att.data_ptr(), nbr.data_ptr(), w.data_ptr(),
              alpha.data_ptr(), dscore.data_ptr(), dxr.data_ptr(),
              part.data_ptr(), datt.data_ptr(), d, k, feat, heads, vec,
              DST_BLOCKS, stream)
        rowptr_t, slot_t = gather_agg.transpose_slots(nbr, w, s, stream)
        # the walk over at most D·K entries; the carry's rows keep dxl's
        # alignment (F a multiple of 4 where vec)
        n_max = d * k
        chunk = csr_chunk_edges(n_max)
        slots = 2 * max(1, -(-n_max // chunk))
        carry = torch.empty(slots * (feat + 1), dtype=torch.float32,
                            device=dev)
        _call("sgnn_gatv2_sampled_bwd_src", g.data_ptr(), xl.data_ptr(),
              xr.data_ptr(), att.data_ptr(), alpha.data_ptr(),
              dscore.data_ptr(), rowptr_t.data_ptr(), slot_t.data_ptr(),
              dxl.data_ptr(), carry.data_ptr(),
              carry.data_ptr() + 4 * slots * feat, s, n_max, chunk, feat,
              heads, k, vec, stream)
    gatv2_sampled_bwd_cuda.launches += 1
    return dxl, dxr, datt


gatv2_sampled_fwd_cuda.launches = 0
gatv2_sampled_bwd_cuda.launches = 0
