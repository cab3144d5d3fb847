#!/usr/bin/env python3
"""The f32 error of B2's dtd in four summation forms, on the CPU.

    python3 scripts/torch_b2_identity_error.py

K4's B2 sums, per destination row d and head h, dtd[d,h] = Σ_e c_e·(t_e −
rz[d,h]) with t_e = <Gz[d], ht[s]>_h.  Gz[d] and rz[d] are fixed along the
row, so the same sum is <Gz[d], Σ_e c_e·ht[s]>_h − rz[d,h]·Σ_e c_e: one
dot product a row.  This script restates dtd in f32 in the order of
csrc/gat_bwd.cu's B2 (a warp a destination row, its edges in CSR order) in
four forms — "edge" (a dot product an edge), "unroll" (the identity over
each 4 edges: the kernel), "window" (over each 32 edges) and "row" (over
the whole row) — and prints each one's error, max |Δ| / max |dtd|, against
the plain version `gat_bwd_dst_plain` (f32 sums of f32 per-edge terms),
one JSON line per case.  The cases are scripts/torch_b1_identity_error.py's:
GAT layers on a 2000-vertex graph whose source 5 has 70,000 of its 90,000
edges, with clipped scores, Gz and rz from a cotangent through an f64
forward, seeds 5-10, heads 1 and 2.  Source 5 then holds most of each
destination's attention, so h[d] ≈ ht[5], t_e ≈ rz[d] on its edges, and
the identity's two sums cancel.  Needs no card; imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from sgnn_tpu_torch.ops.gat import (  # noqa: E402
    ATT_CLIP, NEG_SLOPE, gat_bwd_dst_plain,
)
from torch_b1_identity_error import b1_operands, hub_case  # noqa: E402

WINDOW, UNROLL = 32, 4


def b2_operands(ht, ts, td, rowptr, src, dst, cot, heads: int,
                dtype=torch.float32):
    """(ht, ts, gz, td, rz, rowptr, col) as tensors of `dtype` (the CSR's
    int64/int32), the operands of B2 over the CSR keyed by destination:
    Gz and rz as `b1_operands` makes them."""
    ht_, ts_, gz, td_, rz = b1_operands(ht, ts, td, rowptr, src, dst, cot,
                                        heads, dtype)[:5]
    return (ht_, ts_, gz, td_, rz, torch.from_numpy(rowptr),
            torch.from_numpy(src))


def row_order_dtd(ht, ts, gz, td, rz, rowptr, col, heads: int,
                  form: str = "unroll") -> torch.Tensor:
    """dtd in the dtype of the inputs, summed as the kernel's warp sums a
    destination row: per edge, or per group of UNROLL / WINDOW edges or
    the whole row, the groups added in row order."""
    d_rows, f = gz.shape
    fh = f // heads
    rows = torch.repeat_interleave(torch.arange(d_rows), rowptr.diff())
    pos = torch.arange(col.numel()) - rowptr[rows]
    s = col.long()
    sc = ts[s] + td[rows]
    lr = torch.where(sc >= 0, sc, NEG_SLOPE * sc)
    c = (torch.exp(lr.clamp(-ATT_CLIP, ATT_CLIP))
         * torch.where(sc >= 0, 1.0, NEG_SLOPE) * (lr.abs() <= ATT_CLIP))
    if form == "edge":                    # q of each edge, in its slot
        t = (gz[rows].view(-1, heads, fh) * ht[s].view(-1, heads, fh)).sum(-1)
        n_g = int(pos.max()) + 1
        sums = torch.zeros(d_rows * n_g, heads, dtype=ht.dtype).index_add_(
            0, rows * n_g + pos, c * (t - rz[rows])).view(d_rows, n_g, heads)
    else:
        size = {"row": int(pos.max()) + 1, "window": WINDOW,
                "unroll": UNROLL}[form]
        n_g = int(pos.max()) // size + 1
        key = rows * n_g + pos // size
        cx = torch.zeros(d_rows * n_g, f, dtype=ht.dtype).index_add_(
            0, key, (ht[s].view(-1, heads, fh) * c[:, :, None]).view(-1, f))
        csum = torch.zeros(d_rows * n_g, heads, dtype=ht.dtype).index_add_(
            0, key, c)
        sums = ((cx.view(d_rows, n_g, heads, fh)
                 * gz.view(d_rows, 1, heads, fh)).sum(-1)
                - rz.view(d_rows, 1, heads) * csum.view(d_rows, n_g, heads))
    out = torch.zeros(d_rows, heads, dtype=ht.dtype)
    for g in range(n_g):                  # the groups in row order
        out += sums[:, g]
    return out


def main() -> int:
    for heads in (1, 2):
        for seed in range(5, 11):
            case = hub_case(seed, heads)
            args = b2_operands(*case, heads)
            ref = gat_bwd_dst_plain(*args, heads)
            scale = ref.abs().max()
            row = {"heads": heads, "seed": seed,
                   "max_row_edges": int(args[5].diff().max()),
                   "hub_share": float((args[6] == 5).float().mean()),
                   "max_abs_dtd": float(scale)}
            for form in ("edge", "unroll", "window", "row"):
                got = row_order_dtd(*args, heads, form=form)
                row[f"{form}_rel_err"] = float((got - ref).abs().max()
                                               / scale)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
