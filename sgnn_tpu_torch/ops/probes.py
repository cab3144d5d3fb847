"""Rate probes: the port's counterparts of the JAX package's probe scripts.

The scripts under `scripts/` that reach `pl.pallas_call` measured what a
TPU core does with gathers and one-hot tiles.  Each function here computes
the same function as its probe, written for Hopper, with a plain PyTorch
version beside a hand-written CUDA kernel (csrc/probe_gather.cu,
csrc/probe_tile.cu; wrappers in ops/cuda/probes.py):

- **P-G** `gather_sum(table, idx, resident)` — `profile_vmem_gather.py:43`
  `pallas_vmem_gather_sum`: `out[i, :] = Σ_k table[idx[i, k], :]`, one
  output row per tile of indices.  The kernel keeps a column slice of the
  table in shared memory (`resident=True`, the probe's VMEM-resident table)
  or gathers from device memory (`resident=False`).
- **P-S** `shuffle(x, axis)` — `probe_dyngather_shapes.py:18` `probe`:
  `y = take_along_axis(x, idx_i, axis)` with `idx_i[r, c] = (131r + 7c +
  13i) mod (m if axis == 0 else n)`, for every grid step i <
  SHUFFLE_STEPS in turn; the last step's result stands.
- **P-T** `tile_spmm(slab, src, dst, w, r0, d_blk)` —
  `profile_onehot_spmm.py:43` `onehot_spmm`: `out[r0[s, e // e_sub] +
  dst[s, e], :] += f32(w[s, e]) · f32(slab[src[s, e], :])` over every
  step s and edge e, into one [d_blk, F] f32 block.  The kernel sorts the
  edges by output row (stable) and sums each row in that order, so its
  result is bit for bit `tile_spmm_ordered` (`tile_row_order` is the
  sort).  `tile_gather(slab, src)` is the gather alone, and
  `tile_part_args` maps each bisect case of `probe_onehot_parts.py` and
  `probe_onehot_parts2.py` onto the two.
- **P-A** `gat_tile(slab, ts, td, src, dst, heads)` —
  `probe_gat_kernel_parts.py:38` `kernel`, one GAT tile per leading index:
  `u = exp(clip(leaky_relu(ts[s] + bf16(td[d])), ±60))` over the table's
  columns; `out[d, head-h columns] += f32(bf16(bf16(u_h) · slab[s]))` and
  `z[d, :] += u` (f32).  An edge with the sentinel source `src = S` adds u
  (with ts's half 0) to z[d] and no message; one with the sentinel
  destination `dst = W` adds nothing.

Public functions take the function's arrays, not the TPU's sublane
copies: the JAX side's `[n, 8, E_T]` index arrays are `[n, E_T]` here
(their row 0), the F-major table of P-G is [T, F] here, and P-G returns one
row per tile where the TPU wrote eight equal ones.

Dispatch follows `spmm_csr`: a CPU tensor goes to the plain version; a
CUDA tensor launches the kernel (or raises).  Index bounds are checked by
the plain versions' indexing on the CPU, and are the caller's on the card:
the input makers below draw them in range.

The input makers draw from `np.random.default_rng(seed)` in the order the
scripts draw, and return numpy arrays.  Values the scripts hold in bf16
come back as f32 arrays already rounded to bf16 (`bf16_round`, through
f32), so that both packages receive the same values.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .gat import ATT_CLIP, NEG_SLOPE

# the probes' feature width (profile_onehot_spmm.py:39, probe_onehot_parts
# .py:15, probe_gat_kernel_parts.py:33, profile_vmem_gather.py:100)
PROBE_F = 128
# P-G: indices per tile (profile_vmem_gather.py:39) and per run (:104); the
# table rows: the probe's own T = 2048 (1 MiB f32, inside the card's L2),
# the Reddit-shaped vertex count (119 MB f32, partly in L2 across its 4.5
# draws a row) and 2^22 (2 GiB f32: almost every draw a row from HBM)
GATHER_TILE = 2048
GATHER_EDGES = 1 << 20
GATHER_ROWS = (2048, 232965, 1 << 22)
# P-S: grid steps per call (probe_dyngather_shapes.py:29; the kernel's
# kShuffleSteps) and the shapes with their gather axis (:65-75)
SHUFFLE_STEPS = 64
SHUFFLE_SHAPES = (((8, 128), 0), ((8, 128), 1), ((128, 128), 0),
                  ((256, 128), 0), ((1024, 128), 0), ((2048, 128), 0),
                  ((128, 256), 1), ((128, 1024), 1), ((512, 512), 0))
# P-T: (S_BLK, D_BLK, E_T, E_sub, W) by key (profile_onehot_spmm.py:184-
# 202) and steps per run (:125: 2^20 edges at E_T = 2048)
TILE_CONFIGS = {
    "0": (1024, 8192, 2048, 256, 1280),
    "1": (768, 8192, 2048, 128, 768),
    "2": (1024, 8192, 2048, 128, 1024),
    "3": (1536, 8192, 2048, 512, 1536),
    "4": (768, 8192, 2048, 256, 1024),
    "5": (1024, 8192, 4096, 256, 1280),
    "6": (2048, 8192, 2048, 512, 2048),
    "7": (1536, 8192, 4096, 512, 1536),
    "8": (1024, 8192, 2048, 512, 1280),
    "9": (2048, 8192, 4096, 1024, 2048),
    "10": (1024, 8192, 8192, 256, 1280),
    "11": (1024, 8192, 4096, 128, 1280),
    "12": (1536, 8192, 8192, 256, 1536),
    "13": (1536, 8192, 4096, 256, 1536),
}
TILE_STEPS = 512
# the bisect cases of probe_onehot_parts.py (c1 :46, c2 :70, c3 :110) and
# probe_onehot_parts2.py (a :46, b :72, c :100), at their sizes
# (probe_onehot_parts.py:16-19, grid of 4 at :56)
TILE_PARTS = ("c1", "c2", "c3", "a", "b", "c")
PART_S_BLK, PART_E_T, PART_W, PART_D_BLK, PART_STEPS = (
    1024, 2048, 1280, 8192, 4)
# P-A: the probe's tile (probe_gat_kernel_parts.py:33-34, :86) and the
# width of its score tables (:92-93); GAT_TILES independent tiles for the
# timing run
GAT_S_BLK, GAT_W, GAT_E, GAT_HEADS, GAT_LIVE, GAT_TABLE_COLS = (
    256, 128, 256, 4, 200, 8)
GAT_TILES = 4096


def bf16_round(a) -> np.ndarray:
    """`a` as float32 values rounded to bfloat16 (round to nearest even
    from f32, as torch's `.to(torch.bfloat16)`)."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return t.to(torch.bfloat16).float().numpy()


def _need(ok: bool, who: str, msg: str) -> None:
    if not ok:
        raise ValueError(f"{who}: {msg}")


def _tensor(who: str, name: str, t: torch.Tensor, dtype: torch.dtype,
            dim: int, device: torch.device) -> None:
    _need(t.dim() == dim and t.dtype == dtype and t.is_contiguous(), who,
          f"{name} must be a contiguous {dim}-D {dtype} tensor, got "
          f"{t.dtype} {tuple(t.shape)}")
    _need(t.device == device, who, f"{name} is on {t.device}, not {device}")


def _dispatch(who: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cpu or cuda tensors, not {t.device}")
    return t.device.type


# --------------------------------------------------------------- P-G -------
def check_gather_args(table: torch.Tensor, idx: torch.Tensor) -> None:
    """Raise ValueError unless table is [T, F] f32 and idx [n_tiles, tile]
    int32, contiguous, on one device."""
    _tensor("gather_sum", "table", table, torch.float32, 2, table.device)
    _tensor("gather_sum", "idx", idx, torch.int32, 2, table.device)
    _need(table.shape[0] > 0 or idx.numel() == 0, "gather_sum",
          "indices into an empty table")


def gather_sum_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: gather every tile's rows, sum them ([n_tiles, F])."""
    n_tiles, tile = idx.shape
    rows = table.index_select(0, idx.reshape(-1).long())
    return rows.view(n_tiles, tile, table.shape[1]).sum(1)


def gather_sum(table: torch.Tensor, idx: torch.Tensor,
               resident: bool = True) -> torch.Tensor:
    """`out[i] = Σ_k table[idx[i, k]]`; on the card from a shared-memory
    column slice of the table (`resident`) or from device memory."""
    if _dispatch("gather_sum", table) == "cpu":
        check_gather_args(table, idx)
        return gather_sum_plain(table, idx)
    from .cuda.probes import gather_sum_cuda

    return gather_sum_cuda(table, idx, resident)


def gather_inputs(seed: int, t_rows: int, edges: int = GATHER_EDGES,
                  feat: int = PROBE_F, tile: int = GATHER_TILE
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """`(table [T, F] f32, idx [edges/tile, tile] int32)`, drawn as
    profile_vmem_gather.py:99-105 draws them."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((t_rows, feat)).astype(np.float32)
    idx = rng.integers(0, t_rows, size=edges).astype(np.int32)
    return table, idx.reshape(-1, tile)


# --------------------------------------------------------------- P-S -------
def check_shuffle_args(x: torch.Tensor, axis: int) -> None:
    _tensor("shuffle", "x", x, torch.float32, 2, x.device)
    _need(axis in (0, 1), "shuffle", f"axis must be 0 or 1, got {axis}")
    _need(min(x.shape) >= 1, "shuffle", f"x is empty: {tuple(x.shape)}")


def shuffle_index(m: int, n: int, axis: int, step: int,
                  device=None) -> torch.Tensor:
    """Grid step `step`'s indices, int64 [m, n]
    (probe_dyngather_shapes.py:22-25)."""
    r = torch.arange(m, device=device).view(m, 1)
    c = torch.arange(n, device=device).view(1, n)
    return (r * 131 + c * 7 + step * 13) % (m if axis == 0 else n)


def shuffle_plain(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Plain version: one `torch.gather` per grid step, in order; the last
    step's result is returned."""
    m, n = x.shape
    for step in range(SHUFFLE_STEPS):
        y = torch.gather(x, axis, shuffle_index(m, n, axis, step, x.device))
    return y


def shuffle(x: torch.Tensor, axis: int) -> torch.Tensor:
    """SHUFFLE_STEPS shuffles of x along `axis`, one per grid step; the
    last one's result (x's values, moved)."""
    if _dispatch("shuffle", x) == "cpu":
        check_shuffle_args(x, axis)
        return shuffle_plain(x, axis)
    from .cuda.probes import shuffle_cuda

    return shuffle_cuda(x, axis)


def shuffle_input(seed: int, m: int, n: int) -> np.ndarray:
    """x [m, n] f32 (probe_dyngather_shapes.py:48)."""
    return np.random.default_rng(seed).standard_normal((m, n)).astype(
        np.float32)


# --------------------------------------------------------------- P-T -------
def check_tile_args(slab: torch.Tensor, src: torch.Tensor,
                    dst: Optional[torch.Tensor], w: Optional[torch.Tensor],
                    r0: Optional[torch.Tensor], d_blk: Optional[int]) -> None:
    """Raise ValueError unless the arguments are what the tile kernel
    takes: slab [S, F] bf16; src [n, E_T] int32; dst (or None: dst[s, e] =
    e) [n, E_T] int32; w (or None: weight 1) [n, E_T] bf16; r0 [n, n_sub]
    int32 with n_sub dividing E_T; d_blk >= 1.  `d_blk=None` (with dst, w
    and r0 None) is the gather alone."""
    who, dev = "tile_spmm", slab.device
    _tensor(who, "slab", slab, torch.bfloat16, 2, dev)
    _tensor(who, "src", src, torch.int32, 2, dev)
    _need(slab.shape[0] > 0 or src.numel() == 0, who,
          "indices into an empty slab")
    if d_blk is None:
        _need(dst is None and w is None and r0 is None, who,
              "the gather takes no dst, w or r0")
        return
    for name, t, dt in (("dst", dst, torch.int32), ("w", w, torch.bfloat16)):
        if t is not None:
            _tensor(who, name, t, dt, 2, dev)
            _need(t.shape == src.shape, who, f"{name} is {tuple(t.shape)}, "
                                             f"src {tuple(src.shape)}")
    _need(r0 is not None, who, "r0 (the window starts) is required")
    _tensor(who, "r0", r0, torch.int32, 2, dev)
    _need(r0.shape[0] == src.shape[0] and r0.shape[1] >= 1
          and src.shape[1] % r0.shape[1] == 0, who,
          f"r0 {tuple(r0.shape)} must be [n_steps, n_sub] with n_sub "
          f"dividing E_T = {src.shape[1]}")
    _need(d_blk >= 1, who, f"d_blk must be >= 1, got {d_blk}")


def tile_rows(src: torch.Tensor, dst: Optional[torch.Tensor],
              r0: torch.Tensor) -> torch.Tensor:
    """Each edge's output row `r0[s, e // e_sub] + dst[s, e]`, int64
    [n, E_T] (dst None: e)."""
    n, e_t = src.shape
    n_sub = r0.shape[1]
    base = r0.long().unsqueeze(2).expand(n, n_sub, e_t // n_sub).reshape(
        n, e_t)
    if dst is None:
        return base + torch.arange(e_t, device=src.device)
    return base + dst.long()


def tile_gather_plain(slab: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Plain version of the gather: `f32(slab[src])`, [n·E_T, F]."""
    return slab.index_select(0, src.reshape(-1).long()).float()


def tile_spmm_plain(slab: torch.Tensor, src: torch.Tensor,
                    dst: Optional[torch.Tensor], w: Optional[torch.Tensor],
                    r0: torch.Tensor, d_blk: int) -> torch.Tensor:
    """Plain version: the weighted messages `index_add_`ed into a zeroed
    [d_blk, F] f32 block (products of two bf16 values, exact in f32)."""
    msgs = tile_gather_plain(slab, src)
    if w is not None:
        msgs = msgs * w.reshape(-1, 1).float()
    out = torch.zeros((d_blk, slab.shape[1]), dtype=torch.float32,
                      device=slab.device)
    return out.index_add_(0, tile_rows(src, dst, r0).reshape(-1), msgs)


def tile_row_order(src: torch.Tensor, dst: Optional[torch.Tensor],
                   r0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edges sorted by output row, stably: `(rows, order)`, int64
    [n·E_T] each, `rows` ascending and `order` the flat edge ids, a row's
    edges in (step, edge) order, as the card's kernel sorts them."""
    return torch.sort(tile_rows(src, dst, r0).reshape(-1), stable=True)


def tile_spmm_ordered(slab: torch.Tensor, src: torch.Tensor,
                      dst: Optional[torch.Tensor], w: Optional[torch.Tensor],
                      r0: torch.Tensor, d_blk: int) -> torch.Tensor:
    """The tile SpMM summed in the card kernel's order: each row's
    messages added one at a time in `tile_row_order`, from f32 zeros.  The
    products of two bf16 values are exact in f32, so the kernel's FMAs
    round as these adds do: its result equals this one bit for bit."""
    rows, order = tile_row_order(src, dst, r0)
    msgs = tile_gather_plain(slab, src)
    if w is not None:
        msgs = msgs * w.reshape(-1, 1).float()
    msgs = msgs[order]
    counts = torch.bincount(rows, minlength=d_blk)
    # each sorted edge's place in its row
    place = (torch.arange(rows.numel(), device=rows.device)
             - (torch.cumsum(counts, 0) - counts)[rows])
    out = torch.zeros((d_blk, slab.shape[1]), dtype=torch.float32,
                      device=slab.device)
    for j in range(int(counts.max()) if rows.numel() else 0):
        at = place == j     # one edge of each row that has a j-th
        out[rows[at]] += msgs[at]
    return out


def tile_spmm(slab: torch.Tensor, src: torch.Tensor,
              dst: Optional[torch.Tensor], w: Optional[torch.Tensor],
              r0: torch.Tensor, d_blk: int) -> torch.Tensor:
    """`out[r0[s, e // e_sub] + dst[s, e]] += w[s, e] · slab[src[s, e]]`,
    f32 [d_blk, F]; on the card sorted by row and summed in order, each
    row written once (bit-identical from run to run)."""
    if _dispatch("tile_spmm", slab) == "cpu":
        check_tile_args(slab, src, dst, w, r0, d_blk)
        return tile_spmm_plain(slab, src, dst, w, r0, d_blk)
    from .cuda.probes import tile_spmm_cuda

    return tile_spmm_cuda(slab, src, dst, w, r0, d_blk)


def tile_gather(slab: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """The gather alone: `f32(slab[src])`, [n·E_T, F]."""
    if _dispatch("tile_gather", slab) == "cpu":
        check_tile_args(slab, src, None, None, None, None)
        return tile_gather_plain(slab, src)
    from .cuda.probes import tile_spmm_cuda

    return tile_spmm_cuda(slab, src, None, None, None, None)


def tile_part_args(part: str, slab: torch.Tensor, src: torch.Tensor,
                   w: torch.Tensor, r0s: torch.Tensor, w_win: int = PART_W,
                   d_blk: int = PART_D_BLK
                   ) -> Tuple[Callable[..., torch.Tensor], tuple]:
    """`(fn, args)` such that `fn(*args)` computes bisect case `part`
    (TILE_PARTS) on the parts scripts' inputs (`tile_part_inputs`):

    - c1: the gather, `out[s·E_T + e] = f32(slab[src[s, e]])`
      (probe_onehot_parts.py:46-52);
    - c2: `out[src % W] += w · msg`, all steps into one [D_BLK, F] block
      (:70-90); c3: the same at window start `r0s[s, 0]` (:110-131);
    - a: `out[e] += msg` for e < E_T, no weight (probe_onehot_parts2.py:
      46-54); b: step s's own [W, F] block, `out[s·W + src % W] += w ·
      msg` (:72-80); c: b without the weight (:100-107).
    """
    n = src.shape[0]
    zeros = torch.zeros((n, 1), dtype=torch.int32, device=src.device)
    if part == "c1":
        return tile_gather, (slab, src)
    if part == "a":
        return tile_spmm, (slab, src, None, None, zeros, d_blk)
    dst = torch.remainder(src, w_win)
    if part in ("b", "c"):
        own = (torch.arange(n, device=src.device, dtype=torch.int32)
               * w_win).view(n, 1)
        return tile_spmm, (slab, src, dst, w if part == "b" else None, own,
                           n * w_win)
    if part == "c2":
        return tile_spmm, (slab, src, dst, w, zeros, d_blk)
    if part == "c3":
        return tile_spmm, (slab, src, dst, w, r0s[:, :1].contiguous(), d_blk)
    raise ValueError(f"tile_part_args: unknown part {part!r}, not one of "
                     f"{TILE_PARTS}")


def tile_inputs(seed: int, s_blk: int, d_blk: int, e_t: int, e_sub: int,
                w_win: int, n_steps: int = TILE_STEPS,
                feat: int = PROBE_F) -> Dict[str, np.ndarray]:
    """slab [S_BLK, F], src, dst, w [n_steps, E_T] and r0 [n_steps,
    E_T/E_sub], drawn as profile_onehot_spmm.py:124-134 draws them (slab
    and w bf16-rounded)."""
    rng = np.random.default_rng(seed)
    slab = bf16_round(rng.standard_normal((s_blk, feat)))
    src = rng.integers(0, s_blk, size=(n_steps, 1, e_t)).astype(np.int32)
    dst = rng.integers(0, w_win, size=(n_steps, 1, e_t)).astype(np.int32)
    w = rng.standard_normal((n_steps, 1, e_t)).astype(np.float32)
    r0 = rng.integers(0, (d_blk - w_win) // 8,
                      size=(n_steps, e_t // e_sub)).astype(np.int32) * 8
    return {"slab": slab, "src": src[:, 0], "dst": dst[:, 0],
            "w": bf16_round(w[:, 0]), "r0": r0}


def tile_part_inputs(seed: int, s_blk: int = PART_S_BLK,
                     e_t: int = PART_E_T, w_win: int = PART_W,
                     d_blk: int = PART_D_BLK, n_steps: int = PART_STEPS,
                     feat: int = PROBE_F) -> Dict[str, np.ndarray]:
    """slab [S_BLK, F], src and w [n_steps, E_T], r0s [n_steps, 8], drawn
    as probe_onehot_parts.py:34-43 draws them (probe_onehot_parts2.py:
    28-35 draws the first three alike)."""
    rng = np.random.default_rng(seed)
    slab = bf16_round(rng.standard_normal((s_blk, feat)))
    src = rng.integers(0, s_blk, size=(n_steps, 1, e_t)).astype(np.int32)
    w = rng.standard_normal((n_steps, 1, e_t)).astype(np.float32)
    r0s = (rng.integers(0, (d_blk - w_win) // 8, size=(n_steps, 8))
           * 8).astype(np.int32)
    return {"slab": slab, "src": src[:, 0], "w": bf16_round(w[:, 0]),
            "r0s": r0s}


# --------------------------------------------------------------- P-A -------
def check_gat_tile_args(slab: torch.Tensor, ts: torch.Tensor,
                        td: torch.Tensor, src: torch.Tensor,
                        dst: torch.Tensor, heads: int) -> None:
    """Raise ValueError unless slab is [N, S, F] bf16, ts [N, S, C] bf16,
    td [N, W, C] f32, src and dst [N, E] int32 (S and W the sentinels),
    with 1 <= heads <= C and heads dividing F."""
    who, dev = "gat_tile", slab.device
    _tensor(who, "slab", slab, torch.bfloat16, 3, dev)
    _tensor(who, "ts", ts, torch.bfloat16, 3, dev)
    _tensor(who, "td", td, torch.float32, 3, dev)
    _tensor(who, "src", src, torch.int32, 2, dev)
    _tensor(who, "dst", dst, torch.int32, 2, dev)
    n, s_blk, feat = slab.shape
    _need(ts.shape[:2] == (n, s_blk) and td.shape[0] == n
          and td.shape[2] == ts.shape[2] and src.shape == dst.shape
          and src.shape[0] == n, who,
          f"shapes slab {tuple(slab.shape)}, ts {tuple(ts.shape)}, td "
          f"{tuple(td.shape)}, src {tuple(src.shape)}, dst "
          f"{tuple(dst.shape)} do not fit [N, S, F], [N, S, C], [N, W, C], "
          f"[N, E], [N, E]")
    _need(1 <= heads <= ts.shape[2] and feat % heads == 0, who,
          f"heads={heads} must be in [1, {ts.shape[2]}] and divide F={feat}")


def gat_tile_plain(slab: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor,
                   heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per-edge u from the gathered table rows, the bf16
    products, and `index_add_` of messages and u into each tile's rows
    (the sentinel row W taken off at the end).  Returns `(out [N, W, F],
    z [N, W, C])`, both f32."""
    n, s_blk, feat = slab.shape
    w_win, cols = td.shape[1], ts.shape[2]
    s, d = src.long(), dst.long()
    live_s, live_d = (s < s_blk)[..., None], (d < w_win)[..., None]
    tile = torch.arange(n, device=slab.device).view(n, 1)
    sc, dc = s.clamp(max=s_blk - 1), d.clamp(max=w_win - 1)
    zero = torch.zeros((), device=slab.device)
    have = torch.where(live_s, ts[tile, sc].float(), zero)
    hadd = torch.where(live_d, td.to(torch.bfloat16)[tile, dc].float(), zero)
    score = have + hadd
    lr = torch.where(score >= 0, score, NEG_SLOPE * score)
    u = torch.exp(torch.clamp(lr, -ATT_CLIP, ATT_CLIP))          # [N, E, C]
    head = torch.arange(feat, device=slab.device) // (feat // heads)
    msg = slab[tile, sc] * u.to(torch.bfloat16)[..., head]       # bf16
    msg = torch.where(live_s & live_d, msg.float(), zero)
    rows = (tile * (w_win + 1) + d).reshape(-1)
    out = torch.zeros((n * (w_win + 1), feat), device=slab.device)
    out.index_add_(0, rows, msg.reshape(-1, feat))
    z = torch.zeros((n * (w_win + 1), cols), device=slab.device)
    z.index_add_(0, rows, torch.where(live_d, u, zero).reshape(-1, cols))
    return (out.view(n, w_win + 1, feat)[:, :w_win].contiguous(),
            z.view(n, w_win + 1, cols)[:, :w_win].contiguous())


def gat_tile(slab: torch.Tensor, ts: torch.Tensor, td: torch.Tensor,
             src: torch.Tensor, dst: torch.Tensor,
             heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GAT tile of the module docstring, `(out, z)`, for each of N
    independent tiles."""
    if _dispatch("gat_tile", slab) == "cpu":
        check_gat_tile_args(slab, ts, td, src, dst, heads)
        return gat_tile_plain(slab, ts, td, src, dst, heads)
    from .cuda.probes import gat_tile_cuda

    return gat_tile_cuda(slab, ts, td, src, dst, heads)


def gat_tile_inputs(seed: int, n_tiles: int = 1, s_blk: int = GAT_S_BLK,
                    w_win: int = GAT_W, n_edges: int = GAT_E,
                    feat: int = PROBE_F, heads: int = GAT_HEADS,
                    n_live: int = GAT_LIVE, cols: int = GAT_TABLE_COLS
                    ) -> Dict[str, np.ndarray]:
    """slab [N, S, F] and ts [N, S, C] (bf16-rounded), td [N, W, C] f32,
    src and dst [N, E] int32: each tile drawn in turn as
    probe_gat_kernel_parts.py:85-95 draws its one tile (tile 0 is the
    probe's), the n_live live edges first, the rest sentinel pads."""
    rng = np.random.default_rng(seed)
    src = np.full((n_tiles, n_edges), s_blk, np.int32)
    dst = np.full((n_tiles, n_edges), w_win, np.int32)
    slab = np.empty((n_tiles, s_blk, feat), np.float32)
    ts = np.zeros((n_tiles, s_blk, cols), np.float32)
    td = np.zeros((n_tiles, w_win, cols), np.float32)
    for t in range(n_tiles):
        src[t, :n_live] = rng.integers(0, s_blk, n_live)
        dst[t, :n_live] = np.sort(rng.integers(0, w_win, n_live))
        slab[t] = rng.standard_normal((s_blk, feat))
        ts[t, :, :heads] = rng.standard_normal((s_blk, heads)) * 0.3
        td[t, :, :heads] = rng.standard_normal((w_win, heads)) * 0.3
    return {"slab": bf16_round(slab), "ts": bf16_round(ts), "td": td,
            "src": src, "dst": dst}


# the makers' arrays that the functions take in bf16
BF16_ARRAYS = ("slab", "ts", "w")


def to_torch(arrays: Dict[str, np.ndarray],
             device) -> Dict[str, torch.Tensor]:
    """A maker's arrays as tensors on `device`, those in BF16_ARRAYS
    (bf16-rounded by the maker, so exactly) as bfloat16."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        device, torch.bfloat16 if k in BF16_ARRAYS else None)
        for k, v in arrays.items()}
