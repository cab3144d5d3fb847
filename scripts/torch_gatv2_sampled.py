#!/usr/bin/env python3
"""Hold the sampled GATv2 kernels (`csrc/gatv2_sampled.cu`) to their plain
versions and time them at the three layers of the gatv2_products cell.

    python3 scripts/torch_gatv2_sampled.py [--out FILE]

The layers are `scripts/torch_gat_sampled.py --products`' random blocks
(PyG's ogbn-products stack 100-4x128-4x128-4x47, fan-out 10-10-10, batch
512: (D, S) as the device sampler pads them, 10 sampled slots and the
own row's under the self-loop rule), with random xl [S, F], xr [D, F],
att [F] and cotangent G, F = 512, 512, 188 at 4 heads.  Per layer:

- the forward (out, alpha) and the backward (dxl, dxr, datt) against the
  plain versions in f64 on the same values (relative error over the
  largest reference element), and bit-identical on repeat;
- CUDA events over 20 calls of the forward and of the backward kernels
  and over 3 plain calls (forward + backward, the plain versions on the
  card's tensors);
- `roofline.kernel_bound` of each kernel at the layer's shape (the kept
  sampled slots, valid destinations and source rows read counted) and
  its share.

Prints the card's name and power limit and one JSON object; `--out` also
writes it to FILE.  Needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from sgnn_tpu_torch import full_f32_products, resolve_device  # noqa: E402
from sgnn_tpu_torch.ops import gatv2_sampled as op  # noqa: E402
from sgnn_tpu_torch.ops.cuda import gatv2_sampled as kern  # noqa: E402
from sgnn_tpu_torch.utils import roofline  # noqa: E402
from torch_gat_sampled import (  # noqa: E402
    PRODUCTS_HEADS, PRODUCTS_K, PRODUCTS_LAYERS, products_blocks,
)
from torch_variant_tools import event_ms, rel_err  # noqa: E402

KERNEL_REPS, PLAIN_REPS = 20, 3


def layer_row(dev, layer, blk, feat, heads, device_name) -> dict:
    gen = torch.Generator().manual_seed(layer)
    (d, k), s = blk.nbr.shape, blk.num_src_pad
    nbr, w = blk.nbr, blk.weight
    xl = torch.randn(s, feat, generator=gen).to(dev)
    xr = torch.randn(d, feat, generator=gen).to(dev)
    att = (2 * torch.randn(feat, generator=gen)
           / (feat // heads) ** 0.5).to(dev)
    g = torch.randn(d, feat, generator=gen).to(dev)
    keep = w != 0
    shape = {"D": d, "K": k, "S": s, "F": feat, "H": heads,
             "nnz": int(keep[:, :PRODUCTS_K].sum()),
             "dv": int(keep[:, PRODUCTS_K].sum()),
             "sv": int(torch.unique(nbr[keep]).numel())}
    row = {"layer": layer, **shape}
    counts = (kern.gatv2_sampled_fwd_cuda.launches,
              kern.gatv2_sampled_bwd_cuda.launches)
    out, alpha = kern.gatv2_sampled_fwd_cuda(xl, xr, att, nbr, w, heads)
    grads = kern.gatv2_sampled_bwd_cuda(g, xl, xr, att, nbr, w, alpha, heads)
    row["launches"] = {
        "fwd": kern.gatv2_sampled_fwd_cuda.launches - counts[0],
        "bwd": kern.gatv2_sampled_bwd_cuda.launches - counts[1]}
    x64 = [t.double() for t in (xl, xr, att)]
    ref_out, ref_alpha = op.gatv2_sampled_fwd_plain(*x64, nbr, w, heads)
    ref = op.gatv2_sampled_bwd_plain(g.double(), *x64, nbr, ref_alpha, heads)
    row["rel_err"] = dict(zip(
        ("out", "alpha", "dxl", "dxr", "datt"),
        [rel_err(out, ref_out), rel_err(alpha, ref_alpha),
         *(rel_err(a, b) for a, b in zip(grads, ref))]))
    again = kern.gatv2_sampled_fwd_cuda(xl, xr, att, nbr, w, heads)
    grads2 = kern.gatv2_sampled_bwd_cuda(g, xl, xr, att, nbr, w, alpha, heads)
    row["repeat_bit_identical"] = bool(
        torch.equal(out, again[0]) and torch.equal(alpha, again[1])
        and all(torch.equal(a, b) for a, b in zip(grads, grads2)))
    del x64, ref_out, ref_alpha, ref, again, grads2
    ms = {"fwd": event_ms(lambda: kern.gatv2_sampled_fwd_cuda(
              xl, xr, att, nbr, w, heads), KERNEL_REPS),
          "bwd": event_ms(lambda: kern.gatv2_sampled_bwd_cuda(
              g, xl, xr, att, nbr, w, alpha, heads), KERNEL_REPS)}

    def plain():
        _, p_alpha = op.gatv2_sampled_fwd_plain(xl, xr, att, nbr, w, heads)
        op.gatv2_sampled_bwd_plain(g, xl, xr, att, nbr, p_alpha, heads)

    ms["plain_fwd_bwd"] = event_ms(plain, PLAIN_REPS)
    row["ms"] = ms
    for kname in ("fwd", "bwd"):
        b = roofline.kernel_bound(f"gatv2_sampled_{kname}", device_name, 4,
                                  **shape)
        b["pct_of_bound"] = 100.0 * b["bound_ms"] / ms[kname]
        row.setdefault("bound", {})[kname] = b
    return row


def measure(dev) -> dict:
    full_f32_products(dev)
    name = torch.cuda.get_device_name(dev)
    rows = []
    for layer, blk in enumerate(products_blocks(dev)):
        rows.append(layer_row(dev, layer, blk, PRODUCTS_LAYERS[layer][2],
                              PRODUCTS_HEADS, name))
        torch.cuda.empty_cache()
    total = {key: sum(r["ms"][key] for r in rows) for key in rows[0]["ms"]}
    return {"device": name, "layers": rows, "ms_per_step": total,
            "bound_ms_per_step": {
                kname: sum(r["bound"][kname]["bound_ms"] for r in rows)
                for kname in ("fwd", "bwd")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    result = {"nvidia_smi": smi, **measure(dev)}
    print(smi, flush=True)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
