"""Wrappers of the sampled GAT layer's kernels (`csrc/gat_sampled.cu`).

- `gat_sampled_fwd_cuda(h, ts, td, nbr, w, seed_in_src, heads)` → `(out
  [D, F] in h's dtype, att [D, K, H] f32)`: one launch, a lane group a
  destination row;
- `gat_sampled_bwd_cuda(g, h, ts, td, nbr, w, seed_in_src, att, heads)` →
  `(dh [S, F] in h's dtype, dts [S, H], dtd [S, H] f32)`: the destination
  pass (dscore [D, K, H] and each row's dtd), the block's transpose keyed
  by source with its slots (`gather_agg.transpose_slots`, K1 dx's radix
  passes), csr_sum.cuh's walk over it (dh and dts, hub sources in
  pieces), then each row's dtd summed onto its own source row over the
  transpose of `seed_in_src` as a one-slot block weighted 0 where the row
  has no valid slot (K1 dx's sum).  No float atomics: bit-identical from
  run to run.

ops/gat_sampled.py has the function.  Both run on PyTorch's current
stream, check device, dtype, contiguity and shapes and raise on anything
the kernels do not take; index bounds are the caller's (the sampler's, by
construction).  Each has a `.launches` counter, raised by one where it
launches its kernels.  `row_layout(a, b, heads, kernel)` names the row
kernels' layout and the instance's registers and local bytes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from ..gat_sampled import check_gat_sampled_args, check_gat_sampled_grad
from ..segment import DTYPE_CODES, csr_chunk_edges
from . import gather_agg
from .build import build_all

_P = ctypes.c_void_p
_I64, _I32 = ctypes.c_longlong, ctypes.c_int
_ARGS = {
    # h, ts, td, nbr, w, seed, out, att; num_dst, k, feat, heads, dtype
    "sgnn_gat_sampled_fwd": [_P] * 8 + [_I64, _I32, _I64, _I32, _I32, _P],
    # g, h, ts, td, nbr, w, seed, att, dscore, dtd_rows, rowflag; num_dst,
    # k, feat, heads, dtype
    "sgnn_gat_sampled_bwd_dst": [_P] * 11 + [_I64, _I32, _I64, _I32, _I32,
                                             _P],
    # g, att, dscore, rowptr_t, slot_t, dh, dts, carry, carry_row; num_src,
    # max_edges, chunk, feat; heads, k; pitch; vec, dtype
    "sgnn_gat_sampled_bwd_src": [_P] * 9 + [_I64] * 4 + [_I32, _I32, _I64,
                                                         _I32, _I32, _P],
    "sgnn_gat_sampled_layout": ([_P, _P, _I64, _I32, _I32, _I32]
                                + [ctypes.POINTER(_I32)] * 5),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    # the backward's transposes are K1's: both libraries' nvcc at once
    lib = build_all(["gat_sampled", "gather_agg"])["gat_sampled"].lib
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


def _require_cuda(x: torch.Tensor, who: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {x.device}")


def gat_sampled_fwd_cuda(h: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                         nbr: torch.Tensor, w: torch.Tensor,
                         seed_in_src: torch.Tensor, heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward on the card: `(out, att)`."""
    _require_cuda(h, "gat_sampled_fwd_cuda")
    check_gat_sampled_args(h, ts, td, nbr, w, seed_in_src, heads)
    (d, k), (s, feat) = nbr.shape, h.shape
    if not (d and k and s):
        return (torch.zeros((d, feat), dtype=h.dtype, device=h.device),
                torch.zeros((d, k, heads), dtype=torch.float32,
                            device=h.device))
    # every element of both is written by the kernel
    out = torch.empty((d, feat), dtype=h.dtype, device=h.device)
    att = torch.empty((d, k, heads), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        _call("sgnn_gat_sampled_fwd", h.data_ptr(), ts.data_ptr(),
              td.data_ptr(), nbr.data_ptr(), w.data_ptr(),
              seed_in_src.data_ptr(), out.data_ptr(), att.data_ptr(), d, k,
              feat, heads, DTYPE_CODES[h.dtype], stream)
    gat_sampled_fwd_cuda.launches += 1
    return out, att


def gat_sampled_bwd_cuda(g: torch.Tensor, h: torch.Tensor, ts: torch.Tensor,
                         td: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
                         seed_in_src: torch.Tensor, att: torch.Tensor,
                         heads: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward on the card: `(dh, dts, dtd)`."""
    _require_cuda(h, "gat_sampled_bwd_cuda")
    check_gat_sampled_args(h, ts, td, nbr, w, seed_in_src, heads)
    check_gat_sampled_grad(g, att, h, nbr, heads)
    (d, k), (s, feat) = nbr.shape, h.shape
    dev = h.device
    if not (d and k and s):
        return (torch.zeros_like(h), torch.zeros_like(ts),
                torch.zeros_like(td))
    dscore = torch.empty((d, k, heads), dtype=torch.float32, device=dev)
    dtd_rows = torch.empty((d, heads), dtype=torch.float32, device=dev)
    rowflag = torch.empty(d, dtype=torch.float32, device=dev)
    dh = torch.empty((s, feat), dtype=h.dtype, device=dev)
    dts = torch.empty((s, heads), dtype=torch.float32, device=dev)
    dtype = DTYPE_CODES[h.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _call("sgnn_gat_sampled_bwd_dst", g.data_ptr(), h.data_ptr(),
              ts.data_ptr(), td.data_ptr(), nbr.data_ptr(), w.data_ptr(),
              seed_in_src.data_ptr(), att.data_ptr(), dscore.data_ptr(),
              dtd_rows.data_ptr(), rowflag.data_ptr(), d, k, feat, heads,
              dtype, stream)
        rowptr_t, slot_t = gather_agg.transpose_slots(nbr, w, s, stream)
        # the walk over at most D·K entries: 4 adjacent columns a load
        # where F and F / heads are multiples of 4 and g and dh aligned; the
        # carry's rows (dh's F columns, then dts's H) keep that alignment
        n_max = d * k
        chunk = csr_chunk_edges(n_max)
        slots = 2 * max(1, -(-n_max // chunk))
        vec = (feat % 4 == 0 and (feat // heads) % 4 == 0
               and g.data_ptr() % 16 == 0 and dh.data_ptr() % 16 == 0)
        pitch = -(-(feat + heads) // 4) * 4 if vec else feat + heads
        carry = torch.empty(slots * (pitch + 1), dtype=torch.float32,
                            device=dev)
        _call("sgnn_gat_sampled_bwd_src", g.data_ptr(), att.data_ptr(),
              dscore.data_ptr(), rowptr_t.data_ptr(), slot_t.data_ptr(),
              dh.data_ptr(), dts.data_ptr(), carry.data_ptr(),
              carry.data_ptr() + 4 * slots * pitch, s, n_max, chunk, feat,
              heads, k, pitch, int(vec), dtype, stream)
        # each row's dtd onto its own source row: seed_in_src as a
        # one-slot block, weight 0 where the row has no valid slot
        dtd = gather_agg.block_sum(dtd_rows, seed_in_src.view(d, 1),
                                   rowflag.view(d, 1), s, stream)
    gat_sampled_bwd_cuda.launches += 1
    return dh, dts, dtd


def row_layout(a: torch.Tensor, b: torch.Tensor, heads: int,
               kernel: str = "fwd") -> dict:
    """The row kernels' layout (`csrc/gat_sampled.cu` `row_layout`) for
    rows a and b (the forward's h and out, or the destination pass's g
    and h): `lanes` a destination row, `vec` columns a load, `cols` column
    groups a lane; and the `registers` and `local_bytes` (spills) a thread
    of the forward's (`kernel="fwd"`) or the destination pass's ("dst")
    instance, as the loaded module reports them."""
    got = [ctypes.c_int() for _ in range(5)]
    fn, err = _entry("sgnn_gat_sampled_layout")
    with torch.cuda.device(a.device):
        rc = fn(a.data_ptr(), b.data_ptr(), a.shape[1], heads,
                DTYPE_CODES[a.dtype], {"fwd": 0, "dst": 1}[kernel],
                *(ctypes.byref(v) for v in got))
    if rc != 0:
        raise RuntimeError(f"gat_sampled_layout failed: {err(rc).decode()}")
    return dict(zip(("lanes", "vec", "cols", "registers", "local_bytes"),
                    (v.value for v in got)))


gat_sampled_fwd_cuda.launches = 0
gat_sampled_bwd_cuda.launches = 0
