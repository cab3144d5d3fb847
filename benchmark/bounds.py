"""Frozen yardsticks of work: each kernel's bytes-once bound and each
step's required floating-point operations.

Kernel bounds are a frozen copy of the formulas of the port's
`utils/roofline.kernel_bound` (PERF.md section 6, "Bound"): the
least time the card could take for a kernel's work, max(bytes once / HBM
rate, operations / float32 rate), each input read once and each output
written once, whatever the kernel reads again.  No kernel time can fall
below it, so a share of it cannot pass 100%.  `b` is the element size of
the rows the kernel reads.

Step FLOPs count, layer by layer (a cell's reference module sums them
for its architecture), what a forward and backward pass require at the
valid shapes of a step: valid destination rows, kept edges and the source
rows they reference, no padding, no recomputation, no evaluation
forward.  The dense products and the aggregations are counted; elementwise work
(activations, dropout, softmax's exponentials, the loss, the optimizer)
is not, so the count is a lower bound of the work and a share of the peak
built on it cannot pass 100%.
"""

from __future__ import annotations

from typing import Dict, Tuple

from .peaks import peaks_for

Work = Tuple[int, int]   # (bytes once, operations)


def k1_fwd(b: int, D: int, K: int, S: int, F: int, nnz: int) -> Work:
    """K1's forward (and dx, the same traffic): nbr and w once, x's S rows,
    the [D, F] rows written; 2 operations a kept slot and column."""
    return D * K * 8 + S * F * b + D * F * b, 2 * nnz * F


def k1_transpose(D: int, K: int, S: int) -> Work:
    """dx's transpose of the block: nbr and w read, the transposed (col, w)
    written, S + 1 row offsets."""
    return D * K * 16 + 8 * (S + 1), 0


def k2(b: int, V: int, E: int, F: int) -> Work:
    """K2, forward or backward over the (transposed) CSR: col and w,
    rowptr, x's V rows read and V rows written."""
    return E * 8 + 8 * (V + 1) + 2 * V * F * b, 2 * E * F


def k3(b: int, V: int, E: int, F: int, H: int) -> Work:
    """K3: ht read and out written, the two score tables and z, rowptr,
    col; 2 operations an (edge, column), 6 an (edge, head), one divide an
    element."""
    once = V * F * b * 2 + 4 * H * V * 3 + 8 * (V + 1) + 4 * E
    return once, 2 * E * F + 6 * E * H + V * F


def _k4(b: int, V: int, E: int, F: int, H: int, row_f32s: int,
        flops_per_col: int) -> Work:
    once = V * F * (b + row_f32s * 4) + 16 * H * V + 8 * (V + 1) + 4 * E
    return once, flops_per_col * E * F + 10 * E * H


def b1(b: int, V: int, E: int, F: int, H: int) -> Work:
    """K4's first pass (rows = sources over the transposed CSR)."""
    return _k4(b, V, E, F, H, 2, 4)


def b2(b: int, V: int, E: int, F: int, H: int) -> Work:
    """K4's second pass (rows = destinations)."""
    return _k4(b, V, E, F, H, 1, 2)


def gat_sampled(b: int, D: int, K: int, S: int, F: int, H: int, nnz: int,
                backward: bool) -> Work:
    """The sampled GAT kernel pair over a [D, K] block of S source rows,
    nnz valid slots: nbr and w, the seeds, the two score tables and att
    [D, K, H] f32 once; h's S rows read; the forward writes out's D rows,
    the backward reads G's D rows and h's S rows and writes dh's S rows,
    dts and dtd.  2 operations a (valid slot, column) a product (one
    forward, two backward); 8 a (valid slot, head) forward, 10 backward."""
    fixed = D * K * 8 + D * 4 + 2 * S * H * 4 + D * K * H * 4
    if not backward:
        return fixed + S * F * b + D * F * b, 2 * nnz * F + 8 * nnz * H
    once = fixed + 2 * S * F * b + D * F * b + 2 * S * H * 4
    return once, 4 * nnz * F + 10 * nnz * H


def bound_s(work: Work, device_name: str) -> float:
    """Seconds of the bytes-once bound of `work` on the named card."""
    once, ops = work
    row = peaks_for(device_name)
    return max(once / row["hbm_bytes_per_s"], ops / row["float32"])


# ---------------------------------------------------------------- step FLOPs
def gcn_layer_flops(nnz: int, dv: int, sv: int, fin: int, fout: int,
                    input_grad: bool) -> int:
    """One weighted-sum layer, forward and backward, in the cheaper of its
    two orders: aggregate then transform (agg·W over the dv destinations)
    or transform then aggregate (the sv referenced sources' rows times W,
    then the sum).  `input_grad`: the layer's input depends on parameters,
    so its gradient is required too."""
    agg_first = (2 * nnz * fin + 2 * dv * fin * fout          # forward
                 + 2 * dv * fin * fout                        # dW
                 + ((2 * dv * fin * fout + 2 * nnz * fin)     # d input
                    if input_grad else 0))
    transform_first = (2 * sv * fin * fout + 2 * nnz * fout  # forward
                       + 2 * nnz * fout + 2 * sv * fin * fout  # d(xW), dW
                       + (2 * sv * fin * fout if input_grad else 0))
    return min(agg_first, transform_first)


def gat_layer_flops(nnz: int, dv: int, sv: int, fin: int, fout: int,
                    input_grad: bool) -> int:
    """One attention layer, forward and backward: the transform of the sv
    rows it reads (sources and the destinations' own rows), the two score
    halves of those rows, the weighted sum over the kept edges; backward
    the sum's two gradients (rows and attention), the score halves'
    gradients and the transform's (dW, and the input's when required).
    Heads split the columns, so they do not change the count."""
    forward = 2 * sv * fin * fout + 2 * sv * fout * 2 + 2 * nnz * fout
    backward = (2 * nnz * fout * 2 + 2 * sv * fout * 2 * 2
                + 2 * sv * fin * fout
                + (2 * sv * fin * fout if input_grad else 0))
    return forward + backward


def kernel_bounds_per_step(kind: str, device_name: str, b: int,
                           shapes: Dict[str, int]) -> float:
    """Seconds of the bytes-once bounds of every launch one training step
    or epoch makes of a kernel group (`kind`), at its shapes:

      gather_agg: K1 forward, dx and dx's transpose, per layer of a sampled
        step; shapes give per layer l: D{l}, K{l}, S{l}, F{l}, nnz{l}
      spmm: K2 forward (two forwards an epoch: training and the METRICS
        clean pass) and backward, per layer; shapes V, E, F{l}
      gat: K3, two forwards an epoch, per layer; shapes V, E, F{l}, H{l}
      gat_bwd: B1 and B2 per layer; shapes V, E, F{l}, H{l}
      gat_sampled: the sampled GAT pair, forward and backward, per layer
        of a sampled step; shapes D{l}, K{l}, S{l}, F{l}, H{l}, nnz{l}
    """
    n_layers = shapes["layers"]
    total = 0.0
    for l in range(n_layers):
        if kind == "gather_agg":
            D, K, S, F, nnz = (shapes[f"{k}{l}"]
                               for k in ("D", "K", "S", "F", "nnz"))
            # the forward and dx move the same bytes
            total += 2 * bound_s(k1_fwd(b, D, K, S, F, nnz), device_name)
            total += bound_s(k1_transpose(D, K, S), device_name)
        elif kind == "spmm":
            w = k2(b, shapes["V"], shapes["E"], shapes[f"F{l}"])
            total += (shapes["forwards"] + 1) * bound_s(w, device_name)
        elif kind == "gat":
            w = k3(b, shapes["V"], shapes["E"], shapes[f"F{l}"],
                   shapes[f"H{l}"])
            total += shapes["forwards"] * bound_s(w, device_name)
        elif kind == "gat_bwd":
            args = (b, shapes["V"], shapes["E"], shapes[f"F{l}"],
                    shapes[f"H{l}"])
            total += bound_s(b1(*args), device_name)
            total += bound_s(b2(*args), device_name)
        elif kind == "gat_sampled":
            args = (b,) + tuple(shapes[f"{k}{l}"]
                                for k in ("D", "K", "S", "F", "H", "nnz"))
            total += bound_s(gat_sampled(*args, False), device_name)
            total += bound_s(gat_sampled(*args, True), device_name)
        else:
            raise ValueError(f"unknown kernel group {kind!r}")
    return total
