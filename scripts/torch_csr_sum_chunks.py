#!/usr/bin/env python3
"""The CSR sum's chunk size (edges a warp) on one NVIDIA card.

    python3 scripts/torch_csr_sum_chunks.py

Times the wrappers of `sgnn_tpu_torch/csrc/csr_sum.cuh` as they are called
(carry scratch and, for K1's dx, the block's transpose included) with
edges a warp set to 32, 64, 128, 256, 512 and 1024 and then as
`ops/segment.csr_chunk_edges` picks them ("adaptive"): the sum over the
Reddit-shaped graph's GCN CSR (`reddit_like_dataset(seed=0, scale=1.0)`,
F = 128 and 41, f32: one serving pass; "fwd_sum", beside K2's forward as
it runs, a warp per row, "fwd"), K2's backward on its transpose (one
whole-graph epoch's backward), and K1's dx and its transpose alone on
the two blocks of one device-sampled GSSAMPLEALLGPU batch (602-128-41,
fanout 25-10, batch 10000: one training step's dx).  Each time is CUDA
events around 20 calls after a warm-up call, L2 not flushed; each result
is held to the plain version (relative max-abs 1e-5).  One JSON line per
chunk size, then for each case one call's device time by kernel
(`torch.profiler`, the adaptive choice), then the card's name and power
limit as nvidia-smi prints them.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.config import RunConfig  # noqa: E402
from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.graph.adjacency import Adjacency  # noqa: E402
from sgnn_tpu_torch.ops import aggregate as agg  # noqa: E402
from sgnn_tpu_torch.ops.cuda import gather_agg as k1  # noqa: E402
from sgnn_tpu_torch.ops.cuda import spmm as k2  # noqa: E402
from sgnn_tpu_torch.ops.segment import (  # noqa: E402
    csr_from_numpy, csr_transpose, spmm_csr_plain,
)
from sgnn_tpu_torch.sampler.blocks import WeightKind  # noqa: E402
from sgnn_tpu_torch.train import build_trainer  # noqa: E402
from sgnn_tpu_torch.train.fullbatch import build_coo  # noqa: E402

CHUNKS = (32, 64, 128, 256, 512, 1024)   # then the adaptive choice
REPS = 20


def time_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_csr_sum_chunks: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ds = reddit_like_dataset(seed=0, scale=1.0)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    v = adj.num_vertices
    src, _, w = build_coo(adj, WeightKind.GCN)
    csr = csr_from_numpy(adj.indptr, src, w, v, dev)
    csr_t = csr_from_numpy(*csr_transpose(adj.indptr, src, w, v), v, dev)
    gen = torch.Generator().manual_seed(0)
    xs = {f: torch.randn(v, f, generator=gen).to(dev) for f in (128, 41)}
    cfg = RunConfig(algorithm="GSSAMPLEALLGPU", layer_sizes=[602, 128, 41],
                    fanout=[25, 10], batch_size=10000, learn_rate=0.01,
                    drop_rate=0.5, epochs=1, seed=0, vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds)
    batch = tr.sample(*next(tr._seed_batches(tr.train_nids, False)))
    blocks = []
    for blk, feat in zip(batch.blocks, (128, 41)):
        g = torch.randn(blk.nbr.shape[0], feat, generator=gen).to(dev)
        x = torch.empty(blk.num_src_pad, feat, device=dev)
        blocks.append((blk.nbr, blk.weight, g, x))
    refs = {(kind, f): spmm_csr_plain(x, *csr) for f, x in xs.items()
            for kind in ("fwd", "fwd_sum")}
    refs.update({("bwd", f): spmm_csr_plain(x, *csr_t)
                 for f, x in xs.items()})
    refs.update({("dx", i): agg.gather_agg_bwd_dx_plain(
        g, nbr, wt, x.shape[0], x.dtype)
        for i, (nbr, wt, g, x) in enumerate(blocks)})
    adaptive = k2.csr_chunk_edges
    for chunk in CHUNKS + ("adaptive",):
        k2.csr_chunk_edges = (adaptive if chunk == "adaptive"
                              else lambda _, c=chunk: c)
        row = {"chunk_edges": chunk, "ms": {}, "rel_err": {}}
        cases = [(("fwd", f), lambda x=x: k2.spmm_csr_cuda(x, *csr))
                 for f, x in xs.items()]
        # the edge-balanced sum on the forward's CSR: the backward's wrapper
        # computes the same function over whichever CSR it is given
        cases += [(("fwd_sum", f), lambda x=x: k2.spmm_csr_bwd_cuda(x, *csr))
                  for f, x in xs.items()]
        cases += [(("bwd", f), lambda x=x: k2.spmm_csr_bwd_cuda(x, *csr_t))
                  for f, x in xs.items()]
        cases += [(("dx", i), lambda b=b: k1.gather_agg_bwd_dx_cuda(
            b[2], b[0], b[1], b[3])) for i, b in enumerate(blocks)]
        for key, fn in cases:
            name = f"{key[0]}_{key[1]}"
            err = rel_err(fn(), refs[key])
            if err > 1e-5:
                raise RuntimeError(f"{name} at chunk {chunk}: {err}")
            row["rel_err"][name] = err
            row["ms"][name] = time_ms(fn)
        for i, (nbr, wt, _, x) in enumerate(blocks):
            row["ms"][f"transpose_{i}"] = time_ms(
                lambda: k1.block_transpose_cuda(nbr, wt, x.shape[0]))
        ms = row["ms"]
        row["serving_pass_ms"] = ms["fwd_128"] + ms["fwd_41"]
        row["serving_pass_sum_ms"] = ms["fwd_sum_128"] + ms["fwd_sum_41"]
        row["epoch_bwd_ms"] = ms["bwd_128"] + ms["bwd_41"]
        row["step_dx_ms"] = ms["dx_0"] + ms["dx_1"]
        print(json.dumps(row), flush=True)
    # where one call's device time goes, kernel by kernel, at the adaptive
    # choice: the wrappers' host work shows as the gap to the events' time
    for key, fn in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        print(json.dumps({
            "profile": f"{key[0]}_{key[1]}",
            "device_us": sum(e.self_device_time_total for e in events),
            "kernels_us": {e.key[:70]: e.self_device_time_total
                           for e in events}}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "V": v, "E": int(adj.num_edges),
                      "blocks": [list(b[0].shape) + [b[3].shape[0]]
                                 for b in blocks]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
