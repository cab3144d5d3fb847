"""Wrappers of the rate-probe kernels (`csrc/probe_gather.cu`,
`csrc/probe_tile.cu`); ops/probes.py has their functions.

- `gather_sum_cuda(table, idx, resident)` → out [n_tiles, F] f32 (P-G);
- `shuffle_cuda(x, axis)` → y [m, n] f32, SHUFFLE_STEPS steps (P-S);
- `tile_spmm_cuda(slab, src, dst, w, r0, d_blk)` → out [d_blk, F] f32,
  d_blk <= MAX_TILE_ROWS, F % 8 == 0: the edges stably sorted by output
  row, then each row's ordered sum, written once (bit-identical from run
  to run; `tile_sum_resources` reads the sum kernel's registers and local
  bytes); with `d_blk=None` (dst, w, r0 None) the gather alone, [n·E_T,
  F], F % 4 == 0 (P-T and its bisect cases);
- `gat_tile_cuda(slab, ts, td, src, dst, heads)` → (out [N, W, F], z [N,
  W, C]) f32 (P-A).

Each launches its kernels on PyTorch's current stream, checks device,
dtype, contiguity, shapes and alignment first and raises on anything the
kernel does not take, and raises if the launch is refused.  Index bounds
are the caller's.  Each has a `.launches` counter, raised by one where it
launches its kernel and nowhere else; it counts calls, so a scatter call
of `tile_spmm_cuda`, which launches two kernels (the grouping, then the
sum), counts one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..probes import (
    check_gat_tile_args, check_gather_args, check_shuffle_args,
    check_tile_args,
)
from .build import build
from .gather_agg import RADIX_BITS, SORT_TILE_SLOTS

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# entry point: (source, argument types before the stream)
_SIGS = {
    "sgnn_probe_gather_sum": ("probe_gather", [_P] * 3 + [_I] * 5),
    "sgnn_probe_shuffle": ("probe_gather", [_P] * 2 + [_I] * 3),
    "sgnn_probe_tile_gather": ("probe_tile", [_P] * 3 + [_L, _I]),
    "sgnn_probe_tile_spmm": ("probe_tile", [_P] * 8 + [_L] + [_I] * 4),
    "sgnn_probe_gat_tile": ("probe_tile", [_P] * 7 + [_I] * 7),
}
# csrc/probe_gather.cu: the resident table's column slice and the shared
# memory it may take (227 KB less the 1 KiB of partial sums and the 8 KiB
# of staged indices), so at most RESIDENT_MAX_ROWS rows
SLICE_COLS = 8
RESIDENT_MAX_ROWS = (232448 - 1024 - 8192) // (SLICE_COLS * 4)
# csrc/probe_tile.cu: the score tables' widest; the tile sum's out rows a
# bucket (2^BUCKET_ROW_BITS), and so its largest out block: 2^RADIX_BITS
# buckets
MAX_TABLE_COLS = 8
BUCKET_ROW_BITS = 5
MAX_TILE_ROWS = 1 << (BUCKET_ROW_BITS + RADIX_BITS)


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    source, argtypes = _SIGS[name]
    lib = build(source).lib
    fn = getattr(lib, name)
    fn.argtypes = argtypes + [_P]
    fn.restype = ctypes.c_int
    err = lib.sgnn_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _launch(name: str, device: torch.device, *args) -> None:
    fn, err = _entry(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")


def _require_cuda(t: torch.Tensor, who: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{who} takes CUDA tensors, got {t.device}")


def _aligned(t: torch.Tensor, nbytes: int, who: str, name: str) -> None:
    if t.data_ptr() % nbytes:
        raise ValueError(f"{who}: {name} must be {nbytes}-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def gather_sum_cuda(table: torch.Tensor, idx: torch.Tensor,
                    resident: bool = True) -> torch.Tensor:
    """Σ of each tile's gathered rows on the card: from shared-memory column
    slices of the table (`resident`, F % 8 == 0, T <= RESIDENT_MAX_ROWS)
    or from device memory (F % 4 == 0)."""
    who = "gather_sum_cuda"
    _require_cuda(table, who)
    check_gather_args(table, idx)
    (t_rows, feat), (n_tiles, tile) = table.shape, idx.shape
    if resident and (feat % SLICE_COLS or t_rows > RESIDENT_MAX_ROWS):
        raise ValueError(f"{who}: the resident table needs F % {SLICE_COLS} "
                         f"== 0 and T <= {RESIDENT_MAX_ROWS}, got "
                         f"{tuple(table.shape)}")
    if not resident and feat % 4:
        raise ValueError(f"{who}: F must be a multiple of 4, got {feat}")
    _aligned(table, 16, who, "table")
    out = torch.empty((n_tiles, feat), dtype=torch.float32,
                      device=table.device)
    if n_tiles == 0 or feat == 0:
        return out
    _launch("sgnn_probe_gather_sum", table.device, table.data_ptr(),
            idx.data_ptr(), out.data_ptr(), t_rows, n_tiles, tile, feat,
            int(resident))
    gather_sum_cuda.launches += 1
    return out


def shuffle_cuda(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Every grid step's shuffle of x on the card (the kernel's
    kShuffleSteps, SHUFFLE_STEPS); the last one's result."""
    _require_cuda(x, "shuffle_cuda")
    check_shuffle_args(x, axis)
    y = torch.empty_like(x)
    _launch("sgnn_probe_shuffle", x.device, x.data_ptr(), y.data_ptr(),
            x.shape[0], x.shape[1], axis)
    shuffle_cuda.launches += 1
    return y


def tile_spmm_cuda(slab: torch.Tensor, src: torch.Tensor,
                   dst: Optional[torch.Tensor], w: Optional[torch.Tensor],
                   r0: Optional[torch.Tensor],
                   d_blk: Optional[int]) -> torch.Tensor:
    """The tile SpMM on the card: each tile of SORT_TILE_SLOTS edges
    groups its edges by bucket of 2^BUCKET_ROW_BITS out rows, stably; then
    a block a bucket walks the tiles' segments in order, groups them by
    row in shared memory, sums each row in (step, edge) order and writes
    it once.  With `d_blk=None` the gather alone."""
    who = "tile_spmm_cuda"
    _require_cuda(slab, who)
    check_tile_args(slab, src, dst, w, r0, d_blk)
    n, feat = src.numel(), slab.shape[1]
    # the gather stores 4 columns a lane; the sum loads 8 (16 bytes)
    vec = 4 if d_blk is None else 8
    if feat % vec:
        raise ValueError(f"{who}: F must be a multiple of {vec}, got {feat}")
    if n >= 1 << 31:
        raise ValueError(f"{who}: at most 2^31 - 1 edges, got {n}")
    if d_blk is not None and d_blk > MAX_TILE_ROWS:
        raise ValueError(f"{who}: at most {MAX_TILE_ROWS} out rows, got "
                         f"{d_blk}")
    _aligned(slab, 2 * vec, who, "slab")
    dev = slab.device
    if d_blk is None:
        out = torch.empty((n, feat), dtype=torch.float32, device=dev)
        if n == 0 or feat == 0:
            return out
        _launch("sgnn_probe_tile_gather", dev, slab.data_ptr(),
                src.data_ptr(), out.data_ptr(), n, feat)
        tile_spmm_cuda.launches += 1
        return out
    if n == 0 or feat == 0:
        return torch.zeros((d_blk, feat), dtype=torch.float32, device=dev)
    out = torch.empty((d_blk, feat), dtype=torch.float32, device=dev)
    tiles = -(-n // SORT_TILE_SLOTS)
    # scratch: each edge's pair in its tile's slots, grouped by bucket, and
    # each tile's bucket offsets
    local = torch.empty(2 * n, dtype=torch.int32, device=dev)
    offsets = torch.empty(tiles * ((1 << RADIX_BITS) + 1), dtype=torch.int32,
                          device=dev)
    _launch("sgnn_probe_tile_spmm", dev, slab.data_ptr(), src.data_ptr(),
            _ptr(dst), _ptr(w), r0.data_ptr(), local.data_ptr(),
            offsets.data_ptr(), out.data_ptr(), n, src.shape[1], r0.shape[1],
            d_blk, feat)
    tile_spmm_cuda.launches += 1  # one call: both kernels
    return out


def tile_sum_resources() -> dict:
    """The tile sum kernel's `registers` and `local_bytes` (spills) a
    thread, as the loaded module reports them."""
    got = [ctypes.c_int() for _ in range(2)]
    lib = build("probe_tile").lib
    fn = lib.sgnn_probe_tile_sum_attrs
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = ctypes.c_int
    rc = fn(*(ctypes.byref(v) for v in got))
    if rc != 0:
        raise RuntimeError(f"sgnn_probe_tile_sum_attrs failed: CUDA error "
                           f"{rc}")
    return dict(zip(("registers", "local_bytes"), (v.value for v in got)))


def gat_tile_cuda(slab: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                  src: torch.Tensor, dst: torch.Tensor,
                  heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GAT tiles on the card, one block a tile: `(out, z)`."""
    who = "gat_tile_cuda"
    _require_cuda(slab, who)
    check_gat_tile_args(slab, ts, td, src, dst, heads)
    n, s_blk, feat = slab.shape
    w_win, cols, n_e = td.shape[1], ts.shape[2], src.shape[1]
    if cols > MAX_TABLE_COLS:
        raise ValueError(f"{who}: at most {MAX_TABLE_COLS} table columns, "
                         f"got {cols}")
    out = torch.empty((n, w_win, feat), dtype=torch.float32,
                      device=slab.device)
    z = torch.empty((n, w_win, cols), dtype=torch.float32,
                    device=slab.device)
    if n == 0 or w_win == 0:
        return out, z
    _launch("sgnn_probe_gat_tile", slab.device, slab.data_ptr(),
            ts.data_ptr(), td.data_ptr(), src.data_ptr(), dst.data_ptr(),
            out.data_ptr(), z.data_ptr(), n, s_blk, w_win, n_e, feat, cols,
            heads)
    gat_tile_cuda.launches += 1
    return out, z


gather_sum_cuda.launches = 0
shuffle_cuda.launches = 0
tile_spmm_cuda.launches = 0
gat_tile_cuda.launches = 0
# the wrappers whose counts a CUDA-graph timing raises by its replays
COUNTED = (gather_sum_cuda, shuffle_cuda, tile_spmm_cuda, gat_tile_cuda)
