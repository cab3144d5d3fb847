#!/usr/bin/env python3
"""Hold the sampled GAT kernels (`csrc/gat_sampled.cu`) to their plain
versions and time them beside the torch-op path they replace, at the
training shapes of one device-sampled GATSAMPLEALLGPU batch.

    python3 scripts/torch_gat_sampled.py [--out FILE]

The batch: GAT 602-128-41 with 4 hidden heads, fanout 25-10, batch
10000, on `reddit_like_dataset(seed=0, scale=1.0)` (chip_smoke.py's
training graph), drawn by the device sampler as the trainer draws it.  Per
layer (F=128 at 4 heads, F=41 at 1), with random rows h, cotangent G and
attention vectors a:

- the forward (out, att) and the backward (dh, dts, dtd) against the plain
  versions in f64 on the same values (relative error over the largest
  reference element), and bit-identical on repeat;
- CUDA events over 20 calls of the forward and of the backward kernels,
  over 3 plain calls (forward + backward), and over 10 calls of the whole
  layer's attention forward + backward under autograd two ways: the
  kernels (`pack_score_tables` and `gat_sampled_aggregate`, the card's
  `models/gnn._gat_layer`) and the torch ops the CPU keeps
  (`models/gnn.gat_attention_ops`: the [D, K, F] edge tensors and
  autograd's `index_add_`), with the peak device memory of each;
- `roofline.kernel_bound` of each kernel at the layer's shape (its valid
  slots counted) and its share; the row kernels' layouts, registers and
  local bytes.

Prints the card's name and power limit and one JSON object; `--out` also
writes it to FILE.  `measure(dev[, ds])` returns the object (chip_smoke.py's
kernel_gat_sampled phase calls it on its graph).  Needs a CUDA device and
imports nothing of JAX.
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

from sgnn_tpu_torch import resolve_device  # noqa: E402
from sgnn_tpu_torch.config import RunConfig  # noqa: E402
from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.models.gnn import gat_attention_ops  # noqa: E402
from sgnn_tpu_torch.ops import gat_sampled as op  # noqa: E402
from sgnn_tpu_torch.ops.cuda import gat_sampled as kern  # noqa: E402
from sgnn_tpu_torch.ops.gat import pack_score_tables  # noqa: E402
from sgnn_tpu_torch.sampler.device import device_sample_batch  # noqa: E402
from sgnn_tpu_torch.train import build_trainer  # noqa: E402
from sgnn_tpu_torch.utils import roofline  # noqa: E402
from torch_variant_tools import event_ms, rel_err  # noqa: E402

LAYERS, FANOUT, BATCH, HEADS = [602, 128, 41], [25, 10], 10000, 4
KERNEL_REPS, PLAIN_REPS, LAYER_REPS = 20, 3, 10


def kernel_layer(h, a, nbr, w, seed_in_src, heads):
    """The same through the kernels, as the card's _gat_layer."""
    fprime = h.shape[-1]
    ts, td = pack_score_tables(h, a[:fprime, 0], a[fprime:, 0], heads)
    return op.gat_sampled_aggregate(h, ts, td, nbr, w, seed_in_src, heads)


def sampled_blocks(dev, ds=None):
    """The blocks of one device-sampled GATSAMPLEALLGPU batch on `ds`
    (by default the Reddit-shaped graph)."""
    if ds is None:
        ds = reddit_like_dataset(seed=0, scale=1.0)
    cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=LAYERS,
                    fanout=FANOUT, batch_size=BATCH, learn_rate=0.01,
                    drop_rate=0.5, epochs=1, seed=0, heads=HEADS,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=dev)
    seeds = torch.zeros(tr.seed_pad, dtype=torch.int32)
    seeds[:BATCH] = torch.from_numpy(tr.train_nids[:BATCH].astype("int32"))
    sample = device_sample_batch(
        torch.Generator(device=dev).manual_seed(1), seeds.to(dev),
        (torch.arange(tr.seed_pad) < BATCH).to(dev), tr.dev_indptr,
        tr.dev_indices, tr.dev_in_deg, tr.dev_out_deg, tr.dev_features,
        tr.dev_labels, tuple(FANOUT), tr.src_pads, tr.weight_kind,
        degree_mode=tr.dev_degree_mode)
    return list(sample.blocks)


def layer_row(dev, layer, blk, feat, heads, device_name):
    gen = torch.Generator().manual_seed(layer)
    (d, k), s = blk.nbr.shape, blk.num_src_pad
    nbr, w, sd = blk.nbr, blk.weight, blk.seed_in_src
    h = torch.randn(s, feat, generator=gen).to(dev)
    g = torch.randn(d, feat, generator=gen).to(dev)
    a = torch.randn(2 * feat, 1, generator=gen).to(dev)
    ts, td = pack_score_tables(h, a[:feat, 0], a[feat:, 0], heads)
    nnz = int((w != 0).sum())
    row = {"layer": layer, "D": d, "K": k, "S": s, "F": feat, "H": heads,
           "valid_slots": nnz}
    # held to plain (f64), bit-identical on repeat
    out, att = kern.gat_sampled_fwd_cuda(h, ts, td, nbr, w, sd, heads)
    grads = kern.gat_sampled_bwd_cuda(g, h, ts, td, nbr, w, sd, att, heads)
    h64, ts64, td64 = h.double(), ts.double(), td.double()
    ref_out, ref_att = op.gat_sampled_fwd_plain(h64, ts64, td64, nbr, w, sd,
                                                heads)
    ref = op.gat_sampled_bwd_plain(g.double(), h64, ts64, td64, nbr, w, sd,
                                   ref_att, heads)
    row["rel_err"] = dict(zip(
        ("out", "att", "dh", "dts", "dtd"),
        [rel_err(out, ref_out), rel_err(att, ref_att),
         *(rel_err(x, y) for x, y in zip(grads, ref))]))
    again = kern.gat_sampled_fwd_cuda(h, ts, td, nbr, w, sd, heads)
    grads2 = kern.gat_sampled_bwd_cuda(g, h, ts, td, nbr, w, sd, att, heads)
    row["repeat_bit_identical"] = bool(
        torch.equal(out, again[0]) and torch.equal(att, again[1])
        and all(torch.equal(x, y) for x, y in zip(grads, grads2)))
    del ref_out, ref_att, ref, h64, ts64, td64, again, grads2
    # times
    ms = {"fwd": event_ms(lambda: kern.gat_sampled_fwd_cuda(
              h, ts, td, nbr, w, sd, heads), KERNEL_REPS),
          "bwd": event_ms(lambda: kern.gat_sampled_bwd_cuda(
              g, h, ts, td, nbr, w, sd, att, heads), KERNEL_REPS)}

    def plain():
        _, p_att = op.gat_sampled_fwd_plain(h, ts, td, nbr, w, sd, heads)
        op.gat_sampled_bwd_plain(g, h, ts, td, nbr, w, sd, p_att, heads)

    ms["plain_fwd_bwd"] = event_ms(plain, PLAIN_REPS)
    for name, fn in (("layer_kernels", kernel_layer),
                     ("layer_torch_ops", gat_attention_ops)):
        hh = h.detach().requires_grad_()
        aa = a.detach().requires_grad_()

        def step():
            y = fn(hh, aa, nbr, w, sd, heads)
            torch.autograd.grad(y, (hh, aa), g)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        ms[name] = event_ms(step, LAYER_REPS)
        row.setdefault("peak_extra_bytes", {})[name] = (
            torch.cuda.max_memory_allocated(dev) - base)
    row["ms"] = ms
    for kname in ("fwd", "bwd"):
        b = roofline.kernel_bound(f"gat_sampled_{kname}", device_name, 4,
                                  D=d, K=k, S=s, F=feat, H=heads, nnz=nnz)
        b["pct_of_bound"] = 100.0 * b["bound_ms"] / ms[kname]
        row.setdefault("bound", {})[kname] = b
    row["layout"] = {"fwd": kern.row_layout(h, out, heads, "fwd"),
                     "dst": kern.row_layout(g, h, heads, "dst")}
    return row


def measure(dev, ds=None) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(dev)
    rows = []
    for layer, blk in enumerate(sampled_blocks(dev, ds)):
        feat = LAYERS[layer + 1]
        heads = HEADS if layer < len(LAYERS) - 2 else 1
        rows.append(layer_row(dev, layer, blk, feat, heads, name))
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
