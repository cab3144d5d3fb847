"""Wrappers of the K1 kernels (`csrc/gather_agg.cu`).

Four entry points, each launching its kernels on PyTorch's current stream:

- `gather_agg_fwd_cuda(x, nbr, w)`      → out [D, F] in x's dtype;
- `block_transpose_cuda(nbr, w, S)`     → the block as a CSR keyed by
  source, `(rowptr_t [S+1], col_t [D*K], w_t [D*K])`, zero-weight slots
  dropped past rowptr_t[S] (a stable radix sort of the slots' keys, then
  a fill kernel);
- `gather_agg_bwd_dx_cuda(g, nbr, w, x)` → dx [S, F] in x's dtype: the
  transpose, then csrc/csr_sum.cuh's sum of g's rows along it, written
  once and bit-identical from run to run;
- `gather_agg_bwd_dw_cuda(g, x, nbr)`    → dw [D, K] f32, a lane group
  a destination row and one butterfly reduction of its K sums
  (`dw_layout` names the layout and the instance's registers and local
  bytes), bit-identical from run to run.

Each checks device, dtype, contiguity and shapes and raises on anything
the kernel does not take; index bounds are the caller's (see
`ops/aggregate.check_block_args`).  Each has a `.launches` counter, raised
by one where it launches its kernel and nowhere else.  The sampled GAT
backward (ops/cuda/gat_sampled.py) shares the transpose's radix passes,
ending in the slots themselves (`transpose_slots`), and dx's transpose
and sum (`block_sum`), counted by its own wrapper.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..aggregate import check_block_args, check_grad_arg, check_transpose_args
from ..segment import DTYPE_CODES
from .build import build
from .spmm import CSR_SUM_ARGTYPES, launch_csr_sum

# dx's transpose sorts the slots' keys by a stable LSD radix sort: digits of
# RADIX_BITS, tiles of SORT_TILE_SLOTS slots a block (csrc/rank_tile.cuh's
# kRadixBits and kTileItems)
RADIX_BITS, SORT_TILE_SLOTS = 9, 2048

_P = ctypes.c_void_p
_I64, _I32 = ctypes.c_longlong, ctypes.c_int
_BLOCK = [_I64, _I32, _I64, _I32, _P]   # num_dst, k_slots, feat, dtype, stream
_ARGS = {
    "sgnn_gather_agg_fwd": [_P] * 4 + _BLOCK,
    "sgnn_gather_agg_bwd_dw": [_P] * 4 + _BLOCK,
    "sgnn_block_transpose_count": [_P] * 4 + [_I64, _I32, _I32, _I64, _P],
    "sgnn_block_transpose_scatter": [_P] * 6 + [_I64, _I32, _I32, _I64, _P],
    "sgnn_block_transpose_fill": [_P] * 5 + [_I64, _I32, _I64, _P],
    "sgnn_block_transpose_fill_slots": [_P] * 3 + [_I64, _I64, _P],
    "sgnn_gather_agg_bwd_dx": CSR_SUM_ARGTYPES,
    "sgnn_gather_agg_dw_layout": ([_P, _P, _I64, _I32, _I32]
                                  + [ctypes.POINTER(_I32)] * 5),
}


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    lib = build("gather_agg").lib
    fn = getattr(lib, name)
    fn.argtypes = _ARGS[name]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _call(name: str, stream: int, *args) -> None:
    """Call a C entry with `args` on `stream` (of the current device);
    raise on an error code."""
    fn, err = _entry(name)
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _require_cuda(x: torch.Tensor, who: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {x.device}")


def _stream(x: torch.Tensor) -> int:
    """The current stream of x's device; launch inside
    `torch.cuda.device(x.device)`."""
    return torch.cuda.current_stream(x.device).cuda_stream


def gather_agg_fwd_cuda(x: torch.Tensor, nbr: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """out[d] = Σ_k w[d,k]·x[nbr[d,k]] on the card."""
    _require_cuda(x, "gather_agg_fwd_cuda")
    check_block_args(x, nbr, w)
    (d, k), feat = nbr.shape, x.shape[1]
    if d == 0 or feat == 0 or k == 0:
        return torch.zeros((d, feat), dtype=x.dtype, device=x.device)
    out = torch.empty((d, feat), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        _call("sgnn_gather_agg_fwd", _stream(x), x.data_ptr(),
              nbr.data_ptr(), w.data_ptr(), out.data_ptr(), d, k, feat,
              DTYPE_CODES[x.dtype])
    gather_agg_fwd_cuda.launches += 1
    return out


def block_transpose_cuda(nbr: torch.Tensor, w: torch.Tensor, num_src: int
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block as a CSR keyed by source on the card, the same tensors as
    `ops/aggregate.block_transpose_plain`: a stable LSD radix sort of the
    slots' keys, RADIX_BITS a pass (a count kernel, `torch.cumsum` of the
    counts, a scatter kernel), then every entry and rowptr_t (a kernel)."""
    _require_cuda(nbr, "block_transpose_cuda")
    check_transpose_args(nbr, w, num_src)
    with torch.cuda.device(nbr.device):
        out = _transpose(nbr, w, num_src, _stream(nbr))
    block_transpose_cuda.launches += int(nbr.numel() > 0)
    return out


def _transpose(nbr: torch.Tensor, w: torch.Tensor, num_src: int,
               stream: int) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """block_transpose_cuda's launches, on `stream` of the current
    device."""
    n_slots, k = nbr.numel(), nbr.shape[1]
    dev = nbr.device
    rowptr_t = torch.empty(num_src + 1, dtype=torch.int64, device=dev)
    col_t = torch.empty(n_slots, dtype=torch.int32, device=dev)
    w_t = torch.empty(n_slots, dtype=torch.float32, device=dev)
    if n_slots == 0:
        return rowptr_t.zero_(), col_t, w_t
    work, src = _sort_slots(nbr, w, num_src, stream)
    _call("sgnn_block_transpose_fill", stream, src, w.data_ptr(),
          col_t.data_ptr(), w_t.data_ptr(), rowptr_t.data_ptr(), n_slots, k,
          num_src)
    return rowptr_t, col_t, w_t


def transpose_slots(nbr: torch.Tensor, w: torch.Tensor, num_src: int,
                    stream: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The transpose's radix passes, then its slots: `(rowptr_t [S+1]
    int64, slot_t [D*K] int32)`, slot_t[i] the slot p = d·K + k of entry
    i (each source's slots in ascending p, zero-weight slots past
    rowptr_t[S]), on `stream` of the current device.  For a caller that
    reads per-slot state itself (ops/cuda/gat_sampled.py); counted by the
    caller's wrapper."""
    check_transpose_args(nbr, w, num_src)
    n_slots = nbr.numel()
    rowptr_t = torch.empty(num_src + 1, dtype=torch.int64, device=nbr.device)
    slot_t = torch.empty(n_slots, dtype=torch.int32, device=nbr.device)
    if n_slots == 0:
        return rowptr_t.zero_(), slot_t
    work, src = _sort_slots(nbr, w, num_src, stream)
    _call("sgnn_block_transpose_fill_slots", stream, src, slot_t.data_ptr(),
          rowptr_t.data_ptr(), n_slots, num_src)
    return rowptr_t, slot_t


def _sort_slots(nbr: torch.Tensor, w: torch.Tensor, num_src: int,
                stream: int) -> tuple[torch.Tensor, int]:
    """The stable radix sort of the slots' (key, slot) pairs: the int32
    workspace, which holds the result until it is freed, and the address
    of the sorted pairs in it."""
    n_slots, dev = nbr.numel(), nbr.device
    tiles = -(-n_slots // SORT_TILE_SLOTS)
    # keys reach num_src: every pass sorts RADIX_BITS more of their bits
    passes = -(-max(1, num_src.bit_length()) // RADIX_BITS)
    # one int32 workspace: two arrays of (key, slot) pairs the passes
    # ping-pong between, the counts and their running sums
    n_counts = tiles << RADIX_BITS
    work = torch.empty(4 * n_slots + 2 * n_counts, dtype=torch.int32,
                       device=dev)
    counts, cums = work[4 * n_slots:].view(2, n_counts)
    pairs = (work.data_ptr(), work.data_ptr() + 8 * n_slots)
    src = 0                # the first pass reads nbr and w
    for step in range(passes):
        _call("sgnn_block_transpose_count", stream, nbr.data_ptr(),
              w.data_ptr(), src, counts.data_ptr(), n_slots, num_src,
              step * RADIX_BITS, tiles)
        torch.cumsum(counts, 0, out=cums)
        _call("sgnn_block_transpose_scatter", stream, nbr.data_ptr(),
              w.data_ptr(), src, counts.data_ptr(), cums.data_ptr(),
              pairs[step % 2], n_slots, num_src, step * RADIX_BITS, tiles)
        src = pairs[step % 2]
    return work, src


def gather_agg_bwd_dx_cuda(g: torch.Tensor, nbr: torch.Tensor,
                           w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """dx[s] = Σ_{nbr[d,k]=s} w[d,k]·g[d] on the card, without atomics:
    `block_transpose_cuda`, then the CSR sum of g's rows along it (rows
    with no entries written as zeros), in x's dtype, rounded once."""
    _require_cuda(x, "gather_agg_bwd_dx_cuda")
    check_block_args(x, nbr, w)
    check_grad_arg(g, x, nbr)
    (d, k), (s, feat) = nbr.shape, x.shape
    if not (d and k and feat and s):
        return torch.zeros((s, feat), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        dx = block_sum(g, nbr, w, s, _stream(x))
    block_transpose_cuda.launches += 1
    gather_agg_bwd_dx_cuda.launches += 1
    return dx


def block_sum(g: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor,
              num_src: int, stream: int) -> torch.Tensor:
    """dx's two steps on `stream` of the current device, counted by the
    caller: the transpose, then the CSR sum of g's rows along it, [S, F]
    in g's dtype.  For nbr, w of D·K >= 1 slots and S >= 1."""
    csr_t = _transpose(nbr, w, num_src, stream)
    return launch_csr_sum(
        functools.partial(_entry, "sgnn_gather_agg_bwd_dx"),
        "gather_agg_bwd_dx", g, *csr_t, nbr.numel(), stream)


def dw_layout(g: torch.Tensor, x: torch.Tensor, k: int) -> dict:
    """How the dw kernel (`csrc/gather_agg.cu` `dw_layout`) lays out a
    destination row: `lanes` a row (32 / lanes rows a warp), `vec` columns
    a load (4: one 16-/8-byte vector where F % 4 == 0 and g and x are
    aligned; 1: scalar), `slots` partial sums a row (K rounded up to 8, 16
    or 32); and the `registers` and `local_bytes` (spills) a thread of
    that kernel instance, as the loaded module reports them."""
    got = [ctypes.c_int() for _ in range(5)]
    fn, err = _entry("sgnn_gather_agg_dw_layout")
    with torch.cuda.device(x.device):
        rc = fn(g.data_ptr(), x.data_ptr(), x.shape[1], k,
                DTYPE_CODES[x.dtype], *(ctypes.byref(v) for v in got))
    if rc != 0:
        raise RuntimeError(f"gather_agg_dw_layout failed: {err(rc).decode()}")
    return dict(zip(("lanes", "vec", "slots", "registers", "local_bytes"),
                    (v.value for v in got)))


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
    with torch.cuda.device(x.device):
        _call("sgnn_gather_agg_bwd_dw", _stream(x), g.data_ptr(),
              x.data_ptr(), nbr.data_ptr(), dw.data_ptr(), d, k, feat,
              DTYPE_CODES[x.dtype])
    gather_agg_bwd_dw_cuda.launches += 1
    return dw


gather_agg_fwd_cuda.launches = 0
block_transpose_cuda.launches = 0
gather_agg_bwd_dx_cuda.launches = 0
gather_agg_bwd_dw_cuda.launches = 0
