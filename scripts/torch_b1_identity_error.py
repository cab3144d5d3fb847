#!/usr/bin/env python3
"""The f32 error of B1's dts in four summation forms, on the CPU.

    python3 scripts/torch_b1_identity_error.py

K4's B1 sums, per source row s and head h, dts[s,h] = Σ_e c_e·(t_e −
rz[d,h]) with t_e = <Gz[d], ht[s]>_h.  ht[s] is fixed along the row, so
the same sum is <Σ_e c_e·Gz[d], ht[s]>_h − Σ_e c_e·rz[d,h]: one dot
product a row.  This script restates dts in f32 in the order of
csrc/gat_bwd.cu's walk (pieces of 256 edges of a row, then the fixed tree:
runs of 16 pieces, then the runs) in four forms — "edge" (a dot product
an edge: the kernel with scalar columns), "unroll" (the identity over each
4 edges: the kernel with vector columns), "window" (over each 32 edges)
and "row" (over each piece) — and prints each one's error, max |Δ| / max
|dts|, against the plain version `gat_bwd_src_plain` (f64 sums over a CSR
with a row past 65,536 edges), one JSON line per case.
The cases are GAT layers whose cotangent G gives Gz = G/z and rz =
<G, h>/z as training does (`ops/gat.gat_bwd_operands`; here from an f64
forward, then rounded to f32, so that every run sees the same inputs), on
a 2000-vertex graph whose source 5 has 70,000 out-edges, with clipped
scores, seeds 5-10, heads 1 and 2.
Where a hub source dominates its destinations' attention, h[d] ≈ ht[s],
so t_e ≈ rz[d] and the identity's two sums cancel.  Needs no card;
imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.ops.gat import (  # noqa: E402
    ATT_CLIP, NEG_SLOPE, gat_bwd_src_plain,
)
from sgnn_tpu_torch.ops.segment import csr_transpose  # noqa: E402

PIECE, RUN, WINDOW, UNROLL = 256, 16, 32, 4


def hub_case(seed: int, heads: int, v: int = 2000, fh: int = 8,
             hub: int = 70000):
    """A GAT layer on a graph whose source 5 has `hub` out-edges, every
    37th source's score half raised past the clip: (ht, ts, td, rowptr,
    src, dst, cot) as numpy arrays."""
    rng = np.random.default_rng(seed)
    f, e = heads * fh, hub + 20000
    dst = np.sort(rng.integers(0, v, e)).astype(np.int32)
    src = rng.integers(0, v, e).astype(np.int32)
    src[rng.choice(e, hub, replace=False)] = 5
    rowptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=rowptr[1:])
    ht = rng.standard_normal((v, f)).astype(np.float32)
    ts = (rng.standard_normal((v, heads)) * 2.0).astype(np.float32)
    ts[::37] += 80.0
    td = (rng.standard_normal((v, heads)) * 2.0).astype(np.float32)
    cot = rng.standard_normal((v, f)).astype(np.float32)
    return ht, ts, td, rowptr, src, dst, cot


def walk_order_dts(ht, ts, gz, td, rz, rowptr_t, col_t, heads: int,
                   form: str = "edge") -> torch.Tensor:
    """dts in the dtype of the inputs, summed as the kernel's walk sums:
    per piece of PIECE edges of a row (per WINDOW edges within it for
    "window"), then the pieces by the fixed tree."""
    v, f = ht.shape
    fh = f // heads
    rows = torch.repeat_interleave(torch.arange(v), rowptr_t.diff())
    pos = torch.arange(col_t.numel()) - rowptr_t[rows]
    d = col_t.long()
    s = ts[rows] + td[d]
    lr = torch.where(s >= 0, s, NEG_SLOPE * s)
    c = (torch.exp(lr.clamp(-ATT_CLIP, ATT_CLIP))
         * torch.where(s >= 0, 1.0, NEG_SLOPE) * (lr.abs() <= ATT_CLIP))
    n_p = int(pos.max()) // PIECE + 1
    if form == "edge":
        t = (gz[d].view(-1, heads, fh) * ht[rows].view(-1, heads, fh)).sum(-1)
        part = torch.zeros(v * n_p, heads, dtype=ht.dtype).index_add_(
            0, rows * n_p + pos // PIECE, c * (t - rz[d]))
        part = part.view(v, n_p, heads)
    else:
        size = {"row": PIECE, "window": WINDOW, "unroll": UNROLL}[form]
        n_w = int(pos.max()) // size + 1
        key = rows * n_w + pos // size
        a2 = torch.zeros(v * n_w, f, dtype=ht.dtype).index_add_(
            0, key, (gz[d].view(-1, heads, fh) * c[:, :, None]).view(-1, f))
        crz = torch.zeros(v * n_w, heads, dtype=ht.dtype).index_add_(
            0, key, c * rz[d])
        part = ((a2.view(v, n_w, heads, fh) * ht.view(v, 1, heads, fh))
                .sum(-1) - crz.view(v, n_w, heads))
        if size < PIECE:               # in order within a piece
            per = PIECE // size
            part = torch.nn.functional.pad(
                part, (0, 0, 0, n_p * per - n_w)).view(v, n_p, per, heads)
            acc = torch.zeros(v, n_p, heads, dtype=ht.dtype)
            for i in range(per):
                acc += part[:, :, i]
            part = acc
    n_g = -(-n_p // RUN)
    part = torch.nn.functional.pad(part, (0, 0, 0, n_g * RUN - n_p))
    runs = torch.zeros(v, n_g, heads, dtype=ht.dtype)
    for i in range(RUN):
        runs += part[:, i::RUN]
    out = torch.zeros(v, heads, dtype=ht.dtype)
    for g in range(n_g):
        out += runs[:, g]
    return out


def b1_operands(ht, ts, td, rowptr, src, dst, cot, heads: int,
                dtype=torch.float32):
    """(ht, ts, gz, td, rz, rowptr_t, col_t) as tensors of `dtype` (the
    CSR's int64/int32): Gz and rz of the cotangent through the layer's
    forward (h, z), taken in f64 with numpy's sequential sums so that
    every run gets the same operands, then rounded to `dtype`; the
    transposed CSR built on the host."""
    v, f = ht.shape
    fh = f // heads
    s = ts.astype(np.float64)[src] + td.astype(np.float64)[dst]
    u = np.exp(np.clip(np.where(s >= 0, s, NEG_SLOPE * s), -ATT_CLIP,
                       ATT_CLIP))
    z = np.zeros((v, heads))
    np.add.at(z, dst, u)
    agg = np.zeros((v, heads, fh))
    np.add.at(agg, dst, ht.astype(np.float64).reshape(v, heads, fh)[src]
              * u[:, :, None])
    zinv = np.where(z > 0, 1.0 / np.maximum(z, 1e-30), 0.0)
    g3 = cot.astype(np.float64).reshape(v, heads, fh)
    gz = (g3 * zinv[:, :, None]).reshape(v, f)
    rz = (g3 * agg * zinv[:, :, None] ** 2).sum(-1)
    rowptr_t, col_t, _ = (torch.from_numpy(a) for a in csr_transpose(
        rowptr, src, np.ones(src.size, np.float32), v))
    return (*(torch.from_numpy(np.asarray(a, np.float64)).to(dtype)
              for a in (ht, ts, gz, td, rz)), rowptr_t, col_t)


def main() -> int:
    for heads in (1, 2):
        for seed in range(5, 11):
            args = b1_operands(*hub_case(seed, heads), heads)
            ref = gat_bwd_src_plain(*args, heads)[1]
            scale = ref.abs().max()
            row = {"heads": heads, "seed": seed,
                   "hub_edges": int(args[5].diff().max()),
                   "max_abs_dts": float(scale)}
            for form in ("edge", "unroll", "window", "row"):
                got = walk_order_dts(*args, heads, form=form)
                row[f"{form}_rel_err"] = float((got - ref).abs().max()
                                               / scale)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
