"""Roofline accounting on the card (the port's counterpart of
sgnn_tpu/utils/roofline.py).

Two yardsticks, which answer different questions:

  - `spmm_bytes_model`, `sampled_bytes_model` and `stage_roofline` keep
    the JAX package's signatures, return keys and formulas: a bench
    stage's ns per edge, achieved GB/s under a bytes model that reads ONE
    SOURCE ROW AN EDGE, its % of the HBM peak and its % of the card's
    random-row-access floor.  Two things differ: a row of F elements of
    b bytes counts as ceil(F·b / 32)·32 bytes, the card's 32-byte sector,
    where the TPU's model pads every width to 128 lanes; and the
    constants are the card's.  The byte counts equal JAX's wherever F is
    a multiple of 128 (F = 128 f32, F = 256 bf16: the lanes then pad
    nothing and the sectors are whole).  These are per-edge READINGS, not
    a roofline: the 50 MB L2 serves a source row drawn again without
    going to HBM, so `pct_hbm_peak` can exceed 100.  A GCN f32 serving
    pass on the Reddit-shaped graph (V = 232,965, E = 11,880,013, widths
    [128, 41]) in 2.264 ms reads 8,527,536,512 model bytes, 112% of 3.35
    TB/s (12,403,689,472 bytes and 164% under the TPU's lane padding).
  - `kernel_bound(kernel, device, ...)`: the least time the card could
    take for one kernel's work, max(bytes once / HBM rate, operations /
    f32 rate), each input read once and each output written once.  No
    time can fall below it, so its share cannot exceed 100%.  It is the
    `bound_ms` of every kernel row chip_smoke.py prints; `gather_bound_ms`
    beside it reads a source row an edge instead, as a row gather does.

Constants and their provenance:

  - HBM_BYTES_PER_S: the published HBM bandwidths of the NVIDIA data
    sheets, by device name; HBM_PEAK_GB_S is the H100 SXM's row (3,350).
  - F32_FLOPS_PER_S = 67e12: the H100 SXM data sheet's f32 rate outside
    the tensor cores, where the kernels' FMAs run for both dtypes (bf16
    is widened to f32 on load).
  - ROW_ACCESS_FLOOR_NS: measured on the card by chip_smoke.py's
    row_access_floor phase: a random [232,965, 128] f32 row gather over
    the Reddit-shaped graph's 11,880,013 edge sources in the CSR's order
    (cut to whole 2048-edge tiles), the lesser of the port's P-G
    device-memory gather-sum (`ops/probes.gather_sum`, resident=False)
    and `torch.nn.functional.embedding_bag`, in ns per row.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

# published HBM bandwidths (NVIDIA data sheets), by device name: the first
# key the name contains wins, so the longer H100 names come first
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12), ("H200", 4.8e12))
HBM_PEAK_GB_S = dict(HBM_BYTES_PER_S)["H100"] / 1e9   # H100 SXM, 3,350
# f32 rate outside the tensor cores (H100 SXM data sheet)
F32_FLOPS_PER_S = 67e12
# the card's memory transaction: a row moves in whole 32-byte sectors
SECTOR_BYTES = 32
# random F=128 f32 row gather, ns per row: chip_smoke.py's row_access_floor
# phase, run "15a" of PERF.md, on "NVIDIA H100 80GB HBM3, 700.00 W" (the
# gather-sum 0.0672 ns a row, 0.7982 ms for 11,878,400 rows; embedding_bag
# 0.1961 ns, 2.3289 ms)
ROW_ACCESS_FLOOR_NS = 0.0672


def hbm_bytes_per_s(name: str) -> float:
    """The HBM bandwidth of the card called `name`
    (`torch.cuda.get_device_name`); ValueError for an unknown card."""
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise ValueError(f"no HBM bandwidth known for {name!r}")


def sector_row_bytes(feat: int, dtype_bytes: int) -> int:
    """Bytes the card moves for one row of `feat` elements: whole
    32-byte sectors."""
    return -(-feat * dtype_bytes // SECTOR_BYTES) * SECTOR_BYTES


def lane_row_bytes(feat: int, dtype_bytes: int) -> int:
    """Bytes the TPU's model counts for the same row: the width padded to
    a multiple of 128 lanes, at least 128 (sgnn_tpu/utils/roofline.py)."""
    return max(-(-feat // 128) * 128, 128) * dtype_bytes


RowBytes = Callable[[int, int], int]


def _spmm_bytes(row: RowBytes, edges: int, num_vertices: int,
                layer_widths: Sequence[int], dtype_bytes: int,
                backward: bool) -> int:
    total = 0
    for f in layer_widths:
        fwd = edges * row(f, dtype_bytes) + num_vertices * row(f, 4)
        total += fwd * (3 if backward else 1)  # bwd: g[dst] read + dx write
    return total


def _sampled_bytes(row: RowBytes, edges_per_hop: Sequence[int],
                   feat_dim: int, hidden: int, dtype_bytes: int,
                   backward: bool) -> int:
    widths = [feat_dim] + [hidden] * (len(edges_per_hop) - 1)
    return sum(e * row(f, dtype_bytes) * (2 if backward else 1)
               for e, f in zip(edges_per_hop, widths))


def spmm_bytes_model(
    edges: int, num_vertices: int, layer_widths: Sequence[int],
    dtype_bytes: int = 4, backward: bool = False,
) -> int:
    """Bytes a whole-graph SpMM stack moves reading a source row an edge.

    Per layer of width F: every edge reads one F-wide source row and every
    vertex's f32 accumulator is written once.  `backward=True` triples the
    layer (the gradient's read by destination and its scatter to
    sources).  Rows count in whole 32-byte sectors."""
    return _spmm_bytes(sector_row_bytes, edges, num_vertices, layer_widths,
                       dtype_bytes, backward)


def sampled_bytes_model(
    edges_per_hop: Sequence[int], feat_dim: int, hidden: int,
    dtype_bytes: int = 2, backward: bool = True,
) -> int:
    """Bytes model for one sampled step's aggregation work: the bottom hop
    gathers feat_dim-wide raw feature rows, upper hops hidden-wide
    activations; the backward scatters the same rows again.  Rows count in
    whole 32-byte sectors."""
    return _sampled_bytes(sector_row_bytes, edges_per_hop, feat_dim, hidden,
                          dtype_bytes, backward)


def lane_padded_spmm_bytes_model(
    edges: int, num_vertices: int, layer_widths: Sequence[int],
    dtype_bytes: int = 4, backward: bool = False,
) -> int:
    """`spmm_bytes_model` under the TPU model's 128-lane padding: the JAX
    package's count, for reading beside the card's."""
    return _spmm_bytes(lane_row_bytes, edges, num_vertices, layer_widths,
                       dtype_bytes, backward)


def lane_padded_sampled_bytes_model(
    edges_per_hop: Sequence[int], feat_dim: int, hidden: int,
    dtype_bytes: int = 2, backward: bool = True,
) -> int:
    """`sampled_bytes_model` under the TPU model's 128-lane padding."""
    return _sampled_bytes(lane_row_bytes, edges_per_hop, feat_dim, hidden,
                          dtype_bytes, backward)


def stage_roofline(
    seconds: float, edges: int, model_bytes: int,
    row_ops_per_edge: float = 2.0,
) -> Dict[str, float]:
    """One bench-stage reading.

    `row_ops_per_edge`: how many row-granular random accesses the stage's
    formulation performs per edge (SpMM forward = 1 gather + 1 sorted
    segment-reduce ≈ 2; training steps add the backward scatter ≈ 3).
    `pct_hbm_peak` is the per-edge bytes model's rate over the card's
    peak: it exceeds 100 when L2 serves repeated rows (module docstring);
    a share of a roofline comes from `kernel_bound`."""
    if seconds <= 0 or edges <= 0:
        return {}
    ns_edge = seconds / edges * 1e9
    gb_s = model_bytes / seconds / 1e9
    floor_ns = ROW_ACCESS_FLOOR_NS * row_ops_per_edge
    return {
        "ns_per_edge": round(ns_edge, 2),
        "model_bytes_mb": round(model_bytes / 2**20, 1),
        "achieved_gb_s": round(gb_s, 1),
        "pct_hbm_peak": round(100.0 * gb_s / HBM_PEAK_GB_S, 2),
        "pct_access_floor": round(100.0 * floor_ns / ns_edge, 1),
        "row_ops_per_edge": row_ops_per_edge,
    }


# ---------------------------------------------------------------------------
# Each kernel's work as (bytes once, operations, bytes with a source row
# read an edge); `b` is the element size of the rows the kernel reads.
Work = Tuple[int, int, int]


def _k1(b, D, K, S, F, nnz, ops) -> Work:
    # nbr and w read once, x's S rows, the [D, F] rows written
    fixed = D * K * 8 + D * F * b
    return fixed + S * F * b, ops, fixed + nnz * F * b


def _k1_fwd(b, D, K, S, F, nnz) -> Work:
    return _k1(b, D, K, S, F, nnz, 2 * nnz * F)


def _k1_dw(b, D, K, S, F, nnz) -> Work:
    return _k1(b, D, K, S, F, nnz, 2 * D * K * F)


def _k1_transpose(b, D, K, S) -> Work:
    # nbr and w read, the transposed (col, w) written, rowptr of S + 1
    once = D * K * 16 + 8 * (S + 1)
    return once, 0, once


def _k2(b, V, E, F) -> Work:
    # col and w, rowptr, x's V rows read and V rows written
    fixed = E * 8 + 8 * (V + 1)
    return fixed + 2 * V * F * b, 2 * E * F, fixed + E * F * b + V * F * b


def _k2_pushdown(b, C, V, E, F) -> Work:
    # C cached rows' CSR over the V rows of x
    return (E * 8 + 8 * (C + 1) + (V + C) * F * b, 2 * E * F,
            E * 8 + E * F * b + C * F * b)


def _k3(b, V, E, F, H) -> Work:
    # ht read and out written, the two score tables and z, rowptr, col;
    # 2 flops a (edge, column); a (edge, head) the score add, leaky_relu,
    # the clip's two compares, exp and the z add; one divide an element
    once = V * F * b * 2 + 4 * H * V * 3 + 8 * (V + 1) + 4 * E
    return once, 2 * E * F + 6 * E * H + V * F, E * F * b + once


def _k4(b, V, E, F, H, row_f32s, flops_per_col) -> Work:
    # ~10 operations a (edge, head): score, leaky_relu, the clip, exp, q
    once = V * F * (b + row_f32s * 4) + 16 * H * V + 8 * (V + 1) + 4 * E
    return (once, flops_per_col * E * F + 10 * E * H, once + E * F * b)


def _b1(b, V, E, F, H) -> Work:
    return _k4(b, V, E, F, H, 2, 4)


def _b2(b, V, E, F, H) -> Work:
    return _k4(b, V, E, F, H, 1, 2)


def _gat_sampled(b, D, K, S, F, H, nnz, backward) -> Work:
    # nbr and w, seed, the two score tables and att [D, K, H] f32 (the
    # forward writes it, the backward reads it) once; h's S rows read; the
    # forward writes out's D rows, the backward reads G's D rows and writes
    # dh's S rows and dts, dtd.  A (valid slot, column): 2 flops a product
    # (the forward's att·h; the backward's datt dot and att·G); a (valid
    # slot, head): the score, leaky_relu, max, exp and z, 8 in all forward,
    # 10 backward.  A gather reads a source row a valid slot, forward and
    # in the backward's destination pass, and a G row a slot in its source
    # pass
    fixed = D * K * 8 + D * 4 + 2 * S * H * 4 + D * K * H * 4
    if not backward:
        once = fixed + S * F * b + D * F * b
        return once, 2 * nnz * F + 8 * nnz * H, once + (nnz - S) * F * b
    once = fixed + 2 * S * F * b + D * F * b + 2 * S * H * 4
    return (once, 4 * nnz * F + 10 * nnz * H,
            once + (2 * nnz - S - D) * F * b)


def _gat_sampled_fwd(b, D, K, S, F, H, nnz) -> Work:
    return _gat_sampled(b, D, K, S, F, H, nnz, False)


def _gat_sampled_bwd(b, D, K, S, F, H, nnz) -> Work:
    return _gat_sampled(b, D, K, S, F, H, nnz, True)


def _gatv2_sampled(b, D, K, S, F, H, nnz, dv, sv, backward) -> Work:
    # the block (nbr, w) [D, K] (K counts the own-row slot) and alpha
    # [D, K, H] f32 (the forward writes it, the backward reads it) once;
    # xl's sv rows read (sources and the destinations' own rows), xr's dv
    # rows and att; the forward writes out's D rows, the backward reads
    # G's dv rows and writes dxl's S rows, dxr's D rows and att's
    # gradient.  A (kept sampled slot, column): 6 operations forward (u,
    # leaky_relu, att's product and sum, the weighted sum), 10 backward;
    # the own-row slots left out (nnz counts the kept sampled slots).  A
    # gather reads xl's row a valid slot forward and twice in the
    # backward's destination pass, and G's and xr's rows a valid slot in
    # its source pass
    slots = nnz + dv
    rows_in = (sv + dv) * F * b + F * 4
    if not backward:
        once = D * K * 8 + rows_in + D * F * b + D * K * H * 4
        return once, 6 * nnz * F, once + (slots - sv) * F * b
    once = (D * K * 8 + D * K * H * 4 + rows_in + dv * F * b
            + (S + D) * F * b + F * 4)
    return (once, 10 * nnz * F,
            once + (2 * slots - sv + 2 * slots - 2 * dv) * F * b)


def _gatv2_sampled_fwd(b, D, K, S, F, H, nnz, dv, sv) -> Work:
    return _gatv2_sampled(b, D, K, S, F, H, nnz, dv, sv, False)


def _gatv2_sampled_bwd(b, D, K, S, F, H, nnz, dv, sv) -> Work:
    return _gatv2_sampled(b, D, K, S, F, H, nnz, dv, sv, True)


def _p_g(b, rows_read, E, F, tiles) -> Work:
    # the distinct table rows read, the indices, one summed row a tile
    fixed = E * 4 + tiles * F * 4
    return rows_read * F * b + fixed, E * F, E * F * b + fixed


def _p_s(b, m, n) -> Work:
    return 2 * m * n * b, 0, 2 * m * n * b


def _p_t(b, slab_rows, F, E, windows, out_rows, dst=True,
         weighted=True) -> Work:
    # the bf16 slab, src (and dst, w), the window starts, the f32 block
    once = (slab_rows * F * b + E * 4 + (E * 4 if dst else 0)
            + (E * b if weighted else 0) + windows * 4 + out_rows * F * 4)
    return once, E * F * (2 if weighted else 1), once + E * F * b


def _p_t_gather(b, slab_rows, F, E) -> Work:
    once = slab_rows * F * b + E * 4 + E * F * 4
    return once, 0, once + E * F * b


def _p_a(b, tiles, S, W, E, F, cols, live_dst, live_both) -> Work:
    # slab and ts (b), td (f32), src and dst, out and z (f32)
    once = (tiles * S * F * b + tiles * S * cols * b + tiles * W * cols * 4
            + tiles * E * 8 + tiles * W * (F + cols) * 4)
    return (once, live_dst * cols * 6 + live_both * F * 2,
            once + live_both * F * b)


_KERNELS: Dict[str, Callable[..., Work]] = {
    "k1_fwd": _k1_fwd, "k1_dx": _k1_fwd, "k1_dw": _k1_dw,
    "k1_transpose": _k1_transpose,
    "k2_fwd": _k2, "k2_bwd": _k2, "k2_pushdown": _k2_pushdown,
    "k3": _k3, "b1": _b1, "b2": _b2,
    "gat_sampled_fwd": _gat_sampled_fwd, "gat_sampled_bwd": _gat_sampled_bwd,
    "gatv2_sampled_fwd": _gatv2_sampled_fwd,
    "gatv2_sampled_bwd": _gatv2_sampled_bwd,
    "p_g": _p_g, "p_s": _p_s, "p_t": _p_t, "p_t_gather": _p_t_gather,
    "p_a": _p_a,
}


def kernel_bound(kernel: str, device: str, dtype_bytes: int = 4,
                 **shape) -> Dict[str, object]:
    """The least time the card called `device` could take for `kernel`'s
    work at `shape`, rows of `dtype_bytes`.

    kernel (its shape keywords): k1_fwd, k1_dx, k1_dw (D, K, S, F, nnz);
    k1_transpose (D, K, S); k2_fwd, k2_bwd (V, E, F); k2_pushdown (C, V,
    E, F); k3, b1, b2 (V, E, F, H); gat_sampled_fwd, gat_sampled_bwd (D,
    K, S, F, H, nnz); gatv2_sampled_fwd, gatv2_sampled_bwd (D, K, S, F, H,
    nnz, dv, sv: K with the own-row slot, nnz the kept sampled slots, dv
    the valid destinations, sv the source rows read); p_g (rows_read, E,
    F, tiles); p_s (m,
    n); p_t (slab_rows, F, E, windows, out_rows[, dst, weighted]);
    p_t_gather (slab_rows, F, E); p_a (tiles, S, W, E, F, cols, live_dst,
    live_both).  Where the work depends on the data (K1's and the sampled
    GAT kernels' nonzero slots,
    the rows P-G reads, P-A's live edges) the shape counts this run's.

    Returns bytes_once, operations, gather_bytes, bound_ms = max(bytes
    once / HBM, operations / F32_FLOPS_PER_S), bound_by ("bytes" or
    "operations") and gather_bound_ms (gather_bytes / HBM)."""
    try:
        work = _KERNELS[kernel]
    except KeyError:
        raise ValueError(f"kernel_bound: unknown kernel {kernel!r}, not one "
                         f"of {sorted(_KERNELS)}") from None
    once, ops, gathered = work(dtype_bytes, **shape)
    hbm = hbm_bytes_per_s(device)
    return {"bytes_once": once, "operations": ops, "gather_bytes": gathered,
            "bound_ms": max(once / hbm, ops / F32_FLOPS_PER_S) * 1e3,
            "bound_by": ("bytes" if once / hbm >= ops / F32_FLOPS_PER_S
                         else "operations"),
            "gather_bound_ms": gathered / hbm * 1e3}
