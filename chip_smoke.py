#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sgnn_tpu_torch/csrc/` (nvcc, into
`build/torch_kernels/`), then runs these phases, printing one JSON line each:

1. build     — nvcc time per kernel, and the card's name and power limit;
2. kernel    — `spmm_csr` (the kernel) against `spmm_csr_plain` on the same
               CUDA tensors, on skewed random CSR graphs at F in {7, 41, 128,
               256}, f32 and bf16; then, at the Reddit-shaped serving shapes
               (F=128 and 41, f32 and bf16), the kernel held to the plain
               version at the same tolerances and timed beside it, one
               library call (`torch.sparse.mm`, timed here only, never called
               by the port) and the bound (bytes over HBM bandwidth, flops
               over f32 rate);
3. kernel_k1 — K1's three kernels (`gather_agg_fwd`, `_bwd_dx`, `_bwd_dw`)
               against their plain versions at K in {1, 10, 25}, F in {7, 41,
               128, 602}, f32 and bf16, D not a multiple of 8, zero-weight
               slots and hub sources of 10^4 slots each; then at the two
               full-width training shapes (GraphSAGE 602-128-41, fanout
               25-10, batch 10000: a device-sampled batch's blocks), each
               held to plain and timed beside plain, a library call and the
               bound;
4. kernel_k3 — K3 (`gat_aggregate_cuda`) against `gat_aggregate_plain` on
               skewed random CSR graphs (hub rows of 6000 edges, rows with
               no edges, sources != destinations in one case) at (H, F) in
               {(1,7), (1,41), (1,128), (2,256), (4,128), (8,64), (16,256)}
               (the last: column tiles of 8 heads, two per row), f32 and
               bf16, with the score halves of some source rows raised past
               the ±60 clip; bit-identical on repeat; then at the
               Reddit-shaped GAT
               serving shapes (F=128 at H=1 and 4, F=41 at H=1, f32 and
               bf16) held to plain and timed beside plain, a composition of
               torch ops (scores, `torch.sparse.mm`, z; H=1, f32: no single
               PyTorch call computes K3) and the bound;
5. serving   — GCN 602-128-41 (seed-0 weights) on `reddit_like_dataset(seed=0,
               scale=1.0)` through `InferenceServer.logprobs()`: f32 pass
               time, two kernel launches per pass, agreement with the port's
               CPU pass, then a bf16 server's pass time, its log-probs held to
               the f32 pass within 0.05 and its argmax agreement;
6. queries   — `query(nids)` for requests of 8, 64 and 512 vertices, each
               held to the whole-graph rows, with p50 latency per size;
7. serving_gat — GAT 602-128-41 (seed-0 weights, seeded nonzero attention
               vectors), heads 1 and 4, on the same graph: f32 pass times,
               exactly 2 K3 and 0 SpMM launches per pass, agreement with the
               port's CPU pass, a bf16 server held to the f32 one within 0.05
               with its argmax agreement, queries of 8/64/512 vertices held
               to the whole-graph rows with 2 K3 launches each, p50 latency,
               and one fanout query;
8. train_host   — GCNSAMPLEGPU (host sampler), GCN 602-128-41, fanout 25-10,
               batch 10000: the first batch's loss and weight gradients on
               the card held to the port's CPU on the same blocks and
               parameters (drop 0), then 3 training steps (drop 0.5), with
               per-step time and sampled edges/s;
9. train_device — GSSAMPLEALLGPU (device sampler) at the same widths: one
               whole epoch (16 steps) and `evaluate` on the validation
               vertices; finite losses, the last 4 steps' mean loss below
               the first step's, K1 launched 2 forward + 2 dx per step and 2
               forward per eval batch; per-step median time, sampled
               edges/s, overflow count and train accuracy;
10. train_gat — GATSAMPLEALLGPU (device sampler), GAT 602-128-41, heads 4,
               fanout 25-10, batch 10000: the first batch's loss and every
               weight's and attention vector's gradient on the card held to
               the port's CPU on the same blocks (drop 0, seeded nonzero
               attention), then one epoch (16 steps, drop 0.5) and
               `evaluate`: finite losses, the loss falling, no K1 and no K3
               launch (sampled GAT aggregates with torch ops); per-step
               median time, sampled edges/s, accuracies, peak memory;
11. kernel_k2_bwd — K2's backward (`spmm_csr_bwd_cuda`: the SpMM kernel
               over the transposed CSR, counted apart) against
               `spmm_csr_plain` over the same CSR, on skewed random graphs
               (hub rows, rows with no edges) at F in {7, 41, 128, 256},
               f32 and bf16, bit-identical on repeat; then at the
               Reddit-shaped graph's transposed CSR (F=128 and 41, f32)
               timed beside plain, `torch.sparse.mm` on the transposed CSR
               and the bound;
12. kernel_k4 — K4's two passes (`gat_bwd_src_cuda` B1, `gat_bwd_dst_cuda`
               B2) against their plain versions on K3's grid (clipped
               edges, rows with no in-edges and sources with no out-edges),
               f32 and bf16 ht, bit-identical on repeat; then at the
               Reddit shapes (F=128 H=4, F=128 H=1, F=41 H=1, f32) timed
               beside plain and the bound, with the backward of K3's plain
               version under autograd (H=1) timed as a yardstick;
13. train_full — GCNFULLBATCH, GSFULLBATCH and GATFULLBATCH (heads 4),
               602-128-41, lr 0.01: the first epoch's loss and every
               weight's and attention vector's gradient on the card held to
               the port's CPU at drop 0 on `reddit_like_dataset(seed=0,
               scale=0.25)`, the CPU taking the card's side of relu's kink
               where the two differ (counted); then 5 epochs each at drop
               0.5 on scale 1.0:
               finite losses, the last below the first, exactly 4 SpMM
               forward and 2 backward launches an epoch for GCN/GS (4 K3,
               2 B1, 2 B2 for GAT) and 2 forward launches per `predict()`;
               median epoch time after the first, whole-graph edges/s,
               accuracies, peak memory, the transposed CSR's build time;
14. kernels  — one line listing every kernel with its launches on its main
               path (serving for `spmm_csr`, train_device for K1,
               serving_gat for K3, train_full for K2's backward and K4),
               its error and its times.

Every main path (phases 5-10 and 13) starts with every launch count set to
0 and reads them all at its end.  Then the card's name and power limit as
nvidia-smi prints them, and last `{"ok": true, "device": {...}}`.  Any
failed check raises and the script exits non-zero; nothing falls back to
the CPU or to a plain version.  With no CUDA device it exits 1 and prints
no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# published H100/H200 HBM bandwidths (NVIDIA data sheets), by device name
HBM_BYTES_PER_S = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12),
                   ("H100", 3.35e12), ("H200", 4.8e12))
# f32 rate outside the tensor cores (H100 SXM data sheet): the SpMM's FMAs
# run there for both dtypes, bf16 being widened to f32 on load
F32_FLOPS_PER_S = 67e12

# tolerances of the kernel against its plain version, relative max-abs:
# f32 — both sum in f32, the kernel in CSR edge order with FMAs, the plain
# version by index_add_ (atomics on the card, so another order): only
# reassociation differs, a few f32 ulps of the largest partial sum;
# bf16 — the kernel sums in f32 and rounds once to bf16; it is held to
# the plain version's f32 result on the same values widened to f32
# (`exact_ref`), so the difference is that one rounding, at most 2^-8 of
# an element, plus reassociation; the repo's bf16 kernel bound
# (tests/test_mxu_spmm.py:57).  (Holding it to the plain version's own
# bf16 result instead compares two roundings of sums taken in different
# orders, which land one bf16 ulp, up to 2^-7 of an element, apart when
# the sums straddle a rounding boundary: K1's dx read 6.5e-3 so.)
TOL = {"float32": 1e-5, "bfloat16": 5e-3}
# serving, absolute on log-probs: the card's pass against the port's CPU
# pass and query rows against whole-graph rows — f32 throughout with TF32
# off, so only the summation order of matmul and SpMM differs
SERVE_ATOL = 1e-4
# bf16 server against the f32 server, absolute on log-probs: the bf16 pass
# rounds to 8 significant bits (2^-9 relative) at the feature cast, after
# each of the two products and after each of the two aggregations; through
# the relu and the 602- and 128-term sums that compounds to about 1e-2 of
# activations whose log-probs are O(1) (|log-prob| <= ~5 for these random
# weights), and log_softmax at most doubles a logit error.  0.05 is that
# with margin, the bound tests/test_torch_port_serving.py holds bf16 to.
BF16_SERVE_ATOL = 0.05
# training, card against the port's CPU on the same blocks and parameters
# (drop 0, TF32 off): the loss absolutely, each weight's gradient as
# max|Δg| / max|g| — f32 throughout, only summation orders differ (cuBLAS,
# K1's slot order, dx by atomics), a few f32 ulps through the 602- and
# 128-term sums
TRAIN_LOSS_ATOL = 1e-5
TRAIN_GRAD_RTOL = 1e-4
# the training configuration: the repo's headline stage (bench.py:104-134)
TRAIN_LAYERS, TRAIN_FANOUT, TRAIN_BATCH = [602, 128, 41], [25, 10], 10000
# GAT: scripts/measure_gat_serving.py's serving configuration (heads 1 and
# 4 on the hidden layer) and the training stage above with heads 4.  The
# attention vectors are drawn N(0, 1)·0.1: on these activations the scores
# are then O(1) (init_model's zeros would give uniform attention and leave
# the scores untested)
GAT_SERVE_HEADS, GAT_TRAIN_HEADS, GAT_ATTN_SCALE = (1, 4), 4, 0.1
# K3's check grid: (heads, F).  The scores spread by 2 (the attention
# scale), and one source row in K3_CLIP_EVERY has its score half raised by
# 80, past the ±60 clip: about 1% of the edges, some in every hub row, are
# clipped.  (A spread of 25 on every edge clips too, but with weights
# spanning e^±60 both f32 sums round visibly in the hub rows: kernel
# against plain measured 8.3e-6 at H=8, too close to the 1e-5 bound to
# hold the kernel.)
# (16, 256) has more heads than a column tile of the kernel spans (8), so
# each row is walked once per tile of 8 heads.
K3_GRID = ((1, 7), (1, 41), (1, 128), (2, 256), (4, 128), (8, 64),
           (16, 256))
K3_SCORE_STD, K3_CLIP_EVERY, K3_CLIP_RAISE = 2.0, 97, 80.0
# K4's score-table gradients (dts, dtd) against their plain versions,
# relative max-abs, f32: each sums q_e = u·lrelu'·(t_e − rz), whose two
# terms cancel, so the f32 roundings of t_e (an F-term dot product summed
# in another order by each side) grow by |t_e| / |t_e − rz|
K4_TABLE_TOL = 1e-5
# the whole-graph training stage: the GCN/SAGE/GAT training widths above
# on the Reddit-shaped graph, lr 0.01; exactness at scale 0.25 (the CPU
# reference's passes stay short), speed at scale 1.0, drop 0.5
FULL_ENGINES = (("GCNFULLBATCH", 1), ("GSFULLBATCH", 1),
                ("GATFULLBATCH", GAT_TRAIN_HEADS))
FULL_EXACT_SCALE, FULL_EPOCHS = 0.25, 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError("chip_smoke: " + msg)


def hbm_rate(name: str) -> float:
    for key, rate in HBM_BYTES_PER_S:
        if key in name:
            return rate
    raise RuntimeError(f"chip_smoke: no HBM bandwidth known for {name!r}")


def batch_to(batch, device):
    """A SampledBatch with every tensor moved to `device`."""
    def move(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
            if hasattr(getattr(obj, f.name), "to")})
    return dataclasses.replace(move(batch),
                               blocks=[move(b) for b in batch.blocks])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    from sgnn_tpu_torch.config import RunConfig
    from sgnn_tpu_torch.data.synthetic import reddit_like_dataset
    from sgnn_tpu_torch.graph.adjacency import Adjacency
    from sgnn_tpu_torch.models.gnn import init_model
    from sgnn_tpu_torch.ops import aggregate as agg
    from sgnn_tpu_torch.ops.cuda import gather_agg as k1
    from sgnn_tpu_torch.ops.cuda.build import build_all
    from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda
    from sgnn_tpu_torch.ops.cuda.gat_bwd import (
        gat_bwd_dst_cuda, gat_bwd_src_cuda,
    )
    from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_bwd_cuda, spmm_csr_cuda
    from sgnn_tpu_torch.ops.gat import (
        ATT_CLIP, F32_TINY, NEG_SLOPE, GatAggregate, gat_aggregate_plain,
        gat_bwd_dst_plain, gat_bwd_src_plain, pack_score_tables,
    )
    from sgnn_tpu_torch.ops.segment import csr_transpose, spmm_csr_plain
    from sgnn_tpu_torch.nn.functional import nll_loss_masked
    from sgnn_tpu_torch.train.fullbatch import build_coo
    from sgnn_tpu_torch.sampler.blocks import WeightKind
    from sgnn_tpu_torch.sampler.device import device_sample_batch
    from sgnn_tpu_torch.train import build_trainer
    from sgnn_tpu_torch.train.inference import InferenceServer
    from sgnn_tpu_torch.train.trainer import (
        host_batch_to_device, loss_and_grads,
    )

    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    hbm = hbm_rate(name)

    # ---- 1. build ---------------------------------------------------------
    built = build_all()
    emit({"phase": "build", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "kernels": {n: {"nvcc_s": b.seconds, "lib": b.path.name,
                          "ptxas": [ln.strip() for ln in b.log.splitlines()
                                    if "registers" in ln or "spill" in ln]}
                      for n, b in built.items()}})

    def time_ms(fn, reps: int) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def rel_err(got, ref) -> float:
        ref = ref.float()
        return ((got.float().to(ref.device) - ref).abs().max()
                / ref.abs().max().clamp_min(1e-30)).item()

    def exact_ref(x, *rest):
        """A kernel's arguments for its plain version, with the first (the
        rows, f32 or bf16) widened to f32: the same values, and the plain
        version then returns its f32 sum unrounded."""
        return (x.float(), *rest)

    # every kernel's launch counter: each main path starts from zeros
    counted = {"spmm_csr": spmm_csr_cuda,
               "gather_agg_fwd": k1.gather_agg_fwd_cuda,
               "gather_agg_bwd_dx": k1.gather_agg_bwd_dx_cuda,
               "gather_agg_bwd_dw": k1.gather_agg_bwd_dw_cuda,
               "gat_aggregate": gat_aggregate_cuda,
               "spmm_csr_bwd": spmm_csr_bwd_cuda,
               "gat_bwd_src": gat_bwd_src_cuda,
               "gat_bwd_dst": gat_bwd_dst_cuda}

    def reset_counts() -> None:
        for f in counted.values():
            f.launches = 0

    def counts() -> dict:
        return {n: f.launches for n, f in counted.items()}

    def first_batch(trainer):
        """The first TRAIN_BATCH train vertices of `trainer`, sampled on the
        card with a generator of their own: the trainer's draws stay
        untouched."""
        seeds = torch.zeros(trainer.seed_pad, dtype=torch.int32)
        seeds[:TRAIN_BATCH] = torch.from_numpy(trainer.train_nids[
            :TRAIN_BATCH].astype(np.int32))
        return device_sample_batch(
            torch.Generator(device=dev).manual_seed(1), seeds.to(dev),
            (torch.arange(trainer.seed_pad) < TRAIN_BATCH).to(dev),
            trainer.dev_indptr, trainer.dev_indices, trainer.dev_in_deg,
            trainer.dev_out_deg, trainer.dev_features, trainer.dev_labels,
            tuple(TRAIN_FANOUT), trainer.src_pads, trainer.weight_kind,
            degree_mode=trainer.dev_degree_mode)

    # ---- 2. kernel against its plain version -------------------------------
    gen = torch.Generator().manual_seed(0)
    checks = []
    for feat in (7, 41, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            v = 20000
            deg = (torch.rand(v, generator=gen) ** 4 * 120).long()
            deg[::13] = 0                 # zero-in-degree rows write zeros
            deg[:4] = 6000                # hub rows
            rowptr = torch.zeros(v + 1, dtype=torch.int64)
            rowptr[1:] = deg.cumsum(0)
            e = int(rowptr[-1])
            col = torch.randint(0, v, (e,), generator=gen, dtype=torch.int32)
            w = torch.randn(e, generator=gen)
            x = torch.randn(v, feat, generator=gen).to(dt)
            args = [t.to(dev) for t in (x, rowptr, col, w)]
            out = spmm_csr_cuda(*args)
            again = spmm_csr_cuda(*args)
            torch.cuda.synchronize()
            ref = spmm_csr_plain(*exact_ref(*args))
            err = rel_err(out, ref)
            key = str(dt).removeprefix("torch.")
            checks.append({"F": feat, "dtype": key, "E": e, "rel_err": err,
                           "tol": TOL[key]})
            require(err <= TOL[key], f"kernel vs plain F={feat} {key}: "
                                     f"{err} > {TOL[key]}")
            require(bool((out[::13][1:] == 0).all()),
                    "zero-in-degree rows are not zero")
            require(torch.equal(out, again), "kernel is not deterministic")

    t0 = time.perf_counter()
    ds = reddit_like_dataset(seed=0, scale=1.0)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    data_s = time.perf_counter() - t0
    v, e = adj.num_vertices, adj.num_edges
    params = init_model(0, "gcn", [602, 128, 41], device=dev)
    srv = InferenceServer(params, "gcn", adj, ds.features, device=dev)
    rowptr, col, w = srv.csr
    lib_csr = torch.sparse_csr_tensor(rowptr, col.long(), w, size=(v, v))
    timings = []
    for feat in (128, 41):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(v, feat, generator=gen).to(dev, dt)
            b = x.element_size()
            out = spmm_csr_cuda(x, rowptr, col, w)
            ref = spmm_csr_plain(x.float(), rowptr, col, w)
            err_abs = (out.float() - ref.float()).abs().max().item()
            err = rel_err(out, ref)
            key = str(dt).removeprefix("torch.")
            require(err <= TOL[key], f"kernel vs plain at the serving shape "
                                     f"F={feat} {key}: {err} > {TOL[key]}")
            del ref
            ms = time_ms(lambda: spmm_csr_cuda(x, rowptr, col, w), 20)
            plain_ms = time_ms(lambda: spmm_csr_plain(x, rowptr, col, w), 3)
            # torch.sparse.mm needs values of x's dtype: in bf16 that would
            # round w, another function, so it is timed in f32 only
            library_ms = (time_ms(lambda: torch.sparse.mm(lib_csr, x), 20)
                          if dt == torch.float32 else None)
            once = e * 8 + 8 * (v + 1) + 2 * v * feat * b
            gathered = e * 8 + 8 * (v + 1) + e * feat * b + v * feat * b
            flops = 2 * e * feat
            bound_ms = max(once / hbm, flops / F32_FLOPS_PER_S) * 1e3
            timings.append({
                "F": feat, "dtype": key, "V": v, "E": e,
                "max_abs_err": err_abs, "rel_err": err, "tol": TOL[key],
                "ms": ms,
                "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms,
                "bound_by": ("bytes" if once / hbm >= flops / F32_FLOPS_PER_S
                             else "operations"),
                "gather_bound_ms": gathered / hbm * 1e3,
                "pct_of_bound": 100.0 * bound_ms / ms})
    emit({"phase": "kernel", "checks": checks, "reddit_shapes": timings,
          "hbm_bytes_per_s": hbm, "data_build_s": data_s})

    # ---- 3. K1 kernels against their plain versions -----------------------
    k1_fns = (k1.gather_agg_fwd_cuda, k1.gather_agg_bwd_dx_cuda,
              k1.gather_agg_bwd_dw_cuda)
    k1_checks = []
    d_chk, s_chk, hubs = 40001, 20000, (3, 777, 19999)  # D % 8 != 0
    for k in (1, 10, 25):
        nbr = torch.randint(0, s_chk, (d_chk, k), generator=gen,
                            dtype=torch.int32)
        flat = nbr.view(-1)
        for i, hub in enumerate(hubs):   # 10^4 slots into each hub source
            flat[i * 10000:(i + 1) * 10000] = hub
        w = torch.rand(d_chk, k, generator=gen)
        w[torch.rand(d_chk, k, generator=gen) < 0.3] = 0.0  # padded slots
        nbr, w = nbr.to(dev), w.to(dev)
        for feat in (7, 41, 128, 602):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(s_chk, feat, generator=gen).to(dev, dt)
                g = torch.randn(d_chk, feat, generator=gen).to(dev, dt)
                out = k1.gather_agg_fwd_cuda(x, nbr, w)
                again = k1.gather_agg_fwd_cuda(x, nbr, w)
                dx = k1.gather_agg_bwd_dx_cuda(g, nbr, w, x)
                dw = k1.gather_agg_bwd_dw_cuda(g, x, nbr)
                torch.cuda.synchronize()
                key = str(dt).removeprefix("torch.")
                errs = {
                    "fwd": rel_err(out, agg.gather_aggregate_plain(
                        x.float(), nbr, w)),
                    "dx": rel_err(dx, agg.gather_agg_bwd_dx_plain(
                        g, nbr, w, s_chk, torch.float32)),
                    "dw": rel_err(dw, agg.gather_agg_bwd_dw_plain(g, x, nbr))}
                k1_checks.append({"K": k, "F": feat, "dtype": key,
                                  "rel_err": errs, "tol": TOL[key]})
                for what, err in errs.items():
                    require(err <= TOL[key], f"K1 {what} vs plain K={k} "
                                             f"F={feat} {key}: {err}")
                require(torch.equal(out, again),
                        "K1 forward is not deterministic")

    # the full-width training shapes: the blocks of one device-sampled
    # GSSAMPLEALLGPU batch (its own generator: the trainer's draws in
    # phase 7 are untouched)
    dev_cfg = RunConfig(algorithm="GSSAMPLEALLGPU",
                        layer_sizes=TRAIN_LAYERS, fanout=TRAIN_FANOUT,
                        batch_size=TRAIN_BATCH, learn_rate=0.01,
                        drop_rate=0.5, epochs=1, seed=0,
                        vertices=ds.num_vertices)
    dev_trainer = build_trainer(dev_cfg, ds)
    sample = first_batch(dev_trainer)
    k1_shapes = []
    for layer, feat in ((0, TRAIN_LAYERS[1]), (1, TRAIN_LAYERS[2])):
        blk = sample.blocks[layer]
        nbr, w = blk.nbr, blk.weight
        d_, k_ = nbr.shape
        s_ = blk.num_src_pad
        x = torch.randn(s_, feat, generator=gen).to(dev)
        g = torch.randn(d_, feat, generator=gen).to(dev)
        nnz = int((w != 0).sum())
        rows = torch.arange(d_, device=dev).repeat_interleave(k_)
        fwd_csr = torch.sparse_csr_tensor(
            torch.arange(0, d_ * k_ + 1, k_, device=dev),
            nbr.reshape(-1).long(), w.reshape(-1), size=(d_, s_))
        bwd_csr = torch.sparse_coo_tensor(
            torch.stack([nbr.reshape(-1).long(), rows]), w.reshape(-1),
            size=(s_, d_)).coalesce().to_sparse_csr()
        pattern = torch.sparse_csr_tensor(
            fwd_csr.crow_indices(), fwd_csr.col_indices(),
            torch.zeros(d_ * k_, device=dev), size=(d_, s_))
        x_t = x.t().contiguous()

        def sddmm():
            return torch.sparse.sampled_addmm(pattern, g, x_t, beta=0.0)

        try:   # timed only; the port never calls it
            sddmm()
            dw_library = sddmm
        except RuntimeError:
            dw_library = None
        b = x.element_size()
        once = d_ * k_ * 8 + s_ * feat * b + d_ * feat * b
        gathered = d_ * k_ * 8 + nnz * feat * b + d_ * feat * b
        for kname, fn, plain, lib, flops in (
                ("gather_agg_fwd", lambda: k1.gather_agg_fwd_cuda(x, nbr, w),
                 lambda: agg.gather_aggregate_plain(x, nbr, w),
                 lambda: torch.sparse.mm(fwd_csr, x), 2 * nnz * feat),
                ("gather_agg_bwd_dx",
                 lambda: k1.gather_agg_bwd_dx_cuda(g, nbr, w, x),
                 lambda: agg.gather_agg_bwd_dx_plain(g, nbr, w, s_, x.dtype),
                 lambda: torch.sparse.mm(bwd_csr, g), 2 * nnz * feat),
                ("gather_agg_bwd_dw",
                 lambda: k1.gather_agg_bwd_dw_cuda(g, x, nbr),
                 lambda: agg.gather_agg_bwd_dw_plain(g, x, nbr),
                 dw_library, 2 * d_ * k_ * feat)):
            got, ref = fn(), plain()
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            require(err <= TOL["float32"], f"K1 {kname} vs plain at the "
                                           f"training shape layer {layer}: "
                                           f"{err}")
            bound_s = max(once / hbm, flops / F32_FLOPS_PER_S)
            k1_shapes.append({
                "name": kname, "layer": layer, "D": d_, "K": k_, "S": s_,
                "F": feat, "nnz": nnz, "dtype": "float32",
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "rel_err": err, "tol": TOL["float32"],
                "ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 3),
                "library_ms": time_ms(lib, 20) if lib is not None else None,
                "bound_ms": bound_s * 1e3,
                "bound_by": ("bytes" if once / hbm >= flops / F32_FLOPS_PER_S
                             else "operations"),
                "gather_bound_ms": gathered / hbm * 1e3})
            del got, ref
    del sample, fwd_csr, bwd_csr, pattern
    emit({"phase": "kernel_k1", "checks": k1_checks,
          "training_shapes": k1_shapes})

    # ---- 4. K3 against its plain version -----------------------------------
    def k3_tables(ht, ht_dst, heads, score_std):
        """Score tables from random attention vectors whose scores have
        spread `score_std` on unit-variance rows."""
        feat = ht.shape[1]
        a = torch.randn(2, feat, generator=gen) * (
            score_std / (feat // heads) ** 0.5)
        a = a.to(ht.device)
        ts, _ = pack_score_tables(ht, a[0], a[1], heads)
        _, td = pack_score_tables(ht_dst, a[0], a[1], heads)
        return ts, td

    k3_checks = []
    for heads, feat in K3_GRID:
        for dt in (torch.float32, torch.bfloat16):
            n_dst = 20000
            # one case gathers from a source set other than the rows
            n_src = 15000 if (heads, feat) == (4, 128) else n_dst
            deg = (torch.rand(n_dst, generator=gen) ** 4 * 120).long()
            deg[::13] = 0                 # rows with no edges write zeros
            deg[:4] = 6000                # hub rows
            k_rowptr = torch.zeros(n_dst + 1, dtype=torch.int64)
            k_rowptr[1:] = deg.cumsum(0)
            n_e = int(k_rowptr[-1])
            k_col = torch.randint(0, n_src, (n_e,), generator=gen,
                                  dtype=torch.int32)
            ht = torch.randn(n_src, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, torch.randn(n_dst, feat, generator=gen)
                               .to(dev, dt), heads, K3_SCORE_STD)
            ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
            k_rowptr, k_col = k_rowptr.to(dev), k_col.to(dev)
            raw = (ts.index_select(0, k_col) + td.repeat_interleave(
                k_rowptr.diff(), dim=0))
            clipped = float(((raw > ATT_CLIP)
                             | (NEG_SLOPE * raw < -ATT_CLIP)).float().mean())
            k3 = (ht, ts, td, k_rowptr, k_col, heads)
            h, z = gat_aggregate_cuda(*k3)
            h2, z2 = gat_aggregate_cuda(*k3)
            torch.cuda.synchronize()
            ref_h, ref_z = gat_aggregate_plain(*exact_ref(*k3))
            key = str(dt).removeprefix("torch.")
            # z elementwise: clipped rows' z reach 1e29, so a max-relative
            # error would see nothing in the other rows
            err = rel_err(h, ref_h)
            zerr = ((z - ref_z).abs() / ref_z.abs().clamp_min(F32_TINY)
                    ).max().item()
            k3_checks.append({"H": heads, "F": feat, "dtype": key,
                              "S": n_src, "D": n_dst, "E": n_e,
                              "clipped_share": clipped, "rel_err": err,
                              "z_rel_err": zerr, "tol": TOL[key]})
            require(clipped > 0, f"K3 H={heads} F={feat}: no score clipped")
            require(err <= TOL[key] and zerr <= TOL["float32"],
                    f"K3 vs plain H={heads} F={feat} {key}: {err}, z {zerr}")
            require(bool((h[::13][1:] == 0).all())
                    and bool((z[::13][1:] == 0).all()),
                    "K3: rows with no edges are not zero")
            require(torch.equal(h, h2) and torch.equal(z, z2),
                    "K3 is not deterministic")
            del raw, ref_h, ref_z

    # the serving shapes: the whole Reddit-shaped graph's CSR, H=1 and 4
    g_rowptr, g_col = srv.csr.rowptr, srv.csr.col
    g_col64 = g_col.long()
    rows_e = torch.repeat_interleave(torch.arange(v, device=dev),
                                     g_rowptr.diff())

    def k3_composition(ht, ts, td):
        """K3's function in torch ops (H=1): the scores, u, one
        torch.sparse.mm over a CSR whose values are u, z by index_add_,
        the divide.  Timed as a yardstick only; the port never calls it."""
        s = ts[:, 0].index_select(0, g_col) + td[:, 0].index_select(0, rows_e)
        u = torch.exp(torch.where(s >= 0, s, NEG_SLOPE * s).clamp(
            -ATT_CLIP, ATT_CLIP))
        out = torch.sparse.mm(torch.sparse_csr_tensor(
            g_rowptr, g_col64, u, size=(v, v)), ht)
        z = torch.zeros(v, device=dev).index_add_(0, rows_e, u)
        return out / z.clamp_min(F32_TINY)[:, None]

    k3_shapes = []
    for feat, heads in ((128, 1), (128, 4), (41, 1)):
        for dt in (torch.float32, torch.bfloat16):
            ht = torch.randn(v, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, ht, heads, 2.0)
            got, _ = gat_aggregate_cuda(ht, ts, td, g_rowptr, g_col, heads)
            ref, _ = gat_aggregate_plain(ht.float(), ts, td, g_rowptr, g_col,
                                         heads)
            torch.cuda.synchronize()
            key = str(dt).removeprefix("torch.")
            err = rel_err(got, ref)
            require(err <= TOL[key], f"K3 vs plain at the serving shape "
                                     f"F={feat} H={heads} {key}: {err}")
            comp_ms = comp_err = None
            if heads == 1 and dt == torch.float32:
                comp_err = rel_err(k3_composition(ht, ts, td), ref)
                require(comp_err <= TOL[key], "the composition does not "
                                              f"compute K3: {comp_err}")
                comp_ms = time_ms(lambda: k3_composition(ht, ts, td), 10)
            b = ht.element_size()
            once = (v * feat * b * 2 + 4 * heads * v * 3 + 8 * (v + 1)
                    + 4 * e)
            # 2 flops per (edge, column); per (edge, head) the score add,
            # leaky_relu, the clip's two compares, exp and the z add; one
            # divide per output element
            flops = 2 * e * feat + 6 * e * heads + v * feat
            bound_s = max(once / hbm, flops / F32_FLOPS_PER_S)
            k3_shapes.append({
                "F": feat, "H": heads, "dtype": key, "V": v, "E": e,
                "max_abs_err": (got.float() - ref.float()).abs().max().item(),
                "rel_err": err, "tol": TOL[key],
                "ms": time_ms(lambda: gat_aggregate_cuda(
                    ht, ts, td, g_rowptr, g_col, heads), 20),
                "plain_ms": time_ms(lambda: gat_aggregate_plain(
                    ht, ts, td, g_rowptr, g_col, heads), 3),
                "library_ms": None, "composition_ms": comp_ms,
                "composition_rel_err": comp_err,
                "bound_ms": bound_s * 1e3,
                "bound_by": ("bytes" if once / hbm >= flops / F32_FLOPS_PER_S
                             else "operations"),
                "gather_bound_ms": (e * feat * b + once) / hbm * 1e3})
            del got, ref
    emit({"phase": "kernel_k3", "checks": k3_checks,
          "serving_shapes": k3_shapes,
          "library": "none: no single PyTorch call computes K3; "
                     "composition_ms times scores + torch.sparse.mm + z "
                     "(H=1, f32) as a yardstick"})

    # ---- 5. serving at full width (main path, counted) ----------------------
    reset_counts()
    pass_s = []
    for _ in range(4):
        before = spmm_csr_cuda.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logp = srv.logprobs(as_numpy=False)
        torch.cuda.synchronize()
        pass_s.append(time.perf_counter() - t0)
        require(spmm_csr_cuda.launches - before == 2,
                "logprobs() did not launch the kernel twice")
    full = logp.cpu().numpy()
    require(full.shape == (v, 41) and bool(np.isfinite(full).all()),
            f"log-probs shape {full.shape} or non-finite values")
    t0 = time.perf_counter()
    cpu = InferenceServer(params.to("cpu"), "gcn", adj, ds.features,
                          device="cpu").logprobs()
    cpu_s = time.perf_counter() - t0
    cpu_err = float(np.abs(full - cpu).max())
    require(cpu_err <= SERVE_ATOL, f"card vs CPU pass: {cpu_err}")
    bsrv = InferenceServer(params, "gcn", adj, ds.features,
                           dtype=torch.bfloat16, device=dev)
    bpass_s = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blogp = bsrv.logprobs(as_numpy=False)
        torch.cuda.synchronize()
        bpass_s.append(time.perf_counter() - t0)
    bfull = blogp.cpu().numpy()
    require(bfull.shape == full.shape and bool(np.isfinite(bfull).all()),
            f"bf16 log-probs shape {bfull.shape} or non-finite values")
    bf16_err = float(np.abs(bfull - full).max())
    require(bf16_err <= BF16_SERVE_ATOL,
            f"bf16 vs f32 pass: {bf16_err} > {BF16_SERVE_ATOL}")
    agree = float(np.mean(bfull.argmax(1) == full.argmax(1)))
    del bsrv, blogp
    emit({"phase": "serving", "model": "gcn 602-128-41",
          "graph": {"V": v, "E": e}, "f32_pass_ms": pass_s[0] * 1e3,
          "f32_pass_ms_median_last3": statistics.median(pass_s[1:]) * 1e3,
          "bf16_pass_ms_median_last3": statistics.median(bpass_s[1:]) * 1e3,
          "launches_per_pass": 2, "cpu_pass_max_abs_diff": cpu_err,
          "tol": SERVE_ATOL, "host_cpu_pass_s": cpu_s,
          "bf16_vs_f32_max_abs_diff": bf16_err, "bf16_tol": BF16_SERVE_ATOL,
          "bf16_argmax_agreement": agree})

    # ---- 6. per-request queries (main path, counted) ------------------------
    rng = np.random.default_rng(0)
    lat = {}
    q_err = 0.0
    for size in (8, 64, 512):
        lat[size] = []
        for _ in range(5):
            nids = rng.choice(v, size=size, replace=False)
            before = spmm_csr_cuda.launches
            t0 = time.perf_counter()
            got = srv.query(nids)
            lat[size].append(time.perf_counter() - t0)
            require(spmm_csr_cuda.launches - before == 2,
                    "query() did not launch the kernel twice")
            q_err = max(q_err, float(np.abs(got - full[nids]).max()))
    require(q_err <= SERVE_ATOL, f"query vs whole-graph rows: {q_err}")
    sampled = srv.query(rng.choice(v, size=512, replace=False),
                        fanout=[25, 10], seed=1)
    require(sampled.shape == (512, 41) and bool(np.isfinite(sampled).all()),
            "fanout query shape or values")
    serve_counts = counts()
    launches = serve_counts.pop("spmm_csr")
    require(launches > 0, "the main path never launched spmm_csr")
    require(not any(serve_counts.values()),
            f"GCN serving launched other kernels: {serve_counts}")
    emit({"phase": "queries", "max_abs_diff": q_err, "tol": SERVE_ATOL,
          "p50_ms": {str(s): statistics.median(t) * 1e3
                     for s, t in lat.items()}})
    del srv, logp

    # ---- 7. GAT serving at full width (main path, counted) -----------------
    gat_params = init_model(0, "gat", TRAIN_LAYERS, device=dev)
    attn_gen = torch.Generator().manual_seed(2)
    gat_params = gat_params._replace(attn=tuple(
        (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE).to(dev)
        for a in gat_params.attn))
    reset_counts()
    gat_serving = []
    for heads in GAT_SERVE_HEADS:
        gsrv = InferenceServer(gat_params, "gat", adj, ds.features,
                               heads=heads, device=dev)
        pass_s = []
        for _ in range(4):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logp = gsrv.logprobs(as_numpy=False)
            torch.cuda.synchronize()
            pass_s.append(time.perf_counter() - t0)
            now = counts()
            require(now["gat_aggregate"] - before["gat_aggregate"] == 2
                    and now["spmm_csr"] == before["spmm_csr"],
                    f"GAT logprobs() launched {now} after {before}: "
                    "expected 2 K3 and no SpMM")
        full = logp.cpu().numpy()
        require(full.shape == (v, 41) and bool(np.isfinite(full).all()),
                f"GAT log-probs shape {full.shape} or non-finite values")
        t0 = time.perf_counter()
        cpu = InferenceServer(gat_params.to("cpu"), "gat", adj, ds.features,
                              heads=heads, device="cpu").logprobs()
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(full - cpu).max())
        require(cpu_err <= SERVE_ATOL,
                f"GAT heads {heads} card vs CPU pass: {cpu_err}")
        bsrv = InferenceServer(gat_params, "gat", adj, ds.features,
                               heads=heads, dtype=torch.bfloat16, device=dev)
        bpass_s = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            blogp = bsrv.logprobs(as_numpy=False)
            torch.cuda.synchronize()
            bpass_s.append(time.perf_counter() - t0)
        bfull = blogp.cpu().numpy()
        require(bfull.shape == full.shape and bool(np.isfinite(bfull).all()),
                f"GAT bf16 log-probs shape {bfull.shape} or non-finite")
        bf16_err = float(np.abs(bfull - full).max())
        require(bf16_err <= BF16_SERVE_ATOL,
                f"GAT bf16 vs f32 pass: {bf16_err} > {BF16_SERVE_ATOL}")
        del bsrv, blogp
        lat, q_err = {}, 0.0
        for size in (8, 64, 512):
            lat[size] = []
            for _ in range(5):
                nids = rng.choice(v, size=size, replace=False)
                before = counts()["gat_aggregate"]
                t0 = time.perf_counter()
                got = gsrv.query(nids)
                lat[size].append(time.perf_counter() - t0)
                require(counts()["gat_aggregate"] - before == 2,
                        "GAT query() did not launch K3 twice")
                q_err = max(q_err, float(np.abs(got - full[nids]).max()))
        require(q_err <= SERVE_ATOL, f"GAT query vs whole-graph rows: {q_err}")
        sampled = gsrv.query(rng.choice(v, size=512, replace=False),
                             fanout=[25, 10], seed=1)
        require(sampled.shape == (512, 41)
                and bool(np.isfinite(sampled).all()),
                "GAT fanout query shape or values")
        gat_serving.append({
            "heads": heads, "f32_pass_ms": pass_s[0] * 1e3,
            "f32_pass_ms_median_last3": statistics.median(pass_s[1:]) * 1e3,
            "bf16_pass_ms_median_last3": statistics.median(bpass_s[1:]) * 1e3,
            "cpu_pass_max_abs_diff": cpu_err, "host_cpu_pass_s": cpu_s,
            "bf16_vs_f32_max_abs_diff": bf16_err,
            "bf16_argmax_agreement": float(np.mean(
                bfull.argmax(1) == full.argmax(1))),
            "query_max_abs_diff": q_err,
            "query_p50_ms": {str(s): statistics.median(t) * 1e3
                             for s, t in lat.items()}})
        del gsrv, logp
    gat_counts = counts()
    gat_launches = gat_counts.pop("gat_aggregate")
    require(gat_launches > 0, "the main path never launched gat_aggregate")
    require(not any(gat_counts.values()),
            f"GAT serving launched other kernels: {gat_counts}")
    emit({"phase": "serving_gat", "model": "gat 602-128-41",
          "graph": {"V": v, "E": e}, "tol": SERVE_ATOL,
          "bf16_tol": BF16_SERVE_ATOL, "launches_per_pass": 2,
          "k3_launches": gat_launches, "by_heads": gat_serving})

    # ---- 8. host-sampled training (main path, counted) ---------------------
    host_cfg = RunConfig(algorithm="GCNSAMPLEGPU", layer_sizes=TRAIN_LAYERS,
                         fanout=TRAIN_FANOUT, batch_size=TRAIN_BATCH,
                         learn_rate=0.01, drop_rate=0.5, epochs=1, seed=0,
                         vertices=ds.num_vertices)
    host_trainer = build_trainer(host_cfg, ds)
    order = host_trainer._epoch_order(host_trainer.train_nids)
    item = host_trainer._make_batch(order[:TRAIN_BATCH])
    card_batch, _ = host_trainer._upload(item)
    cpu_batch = host_batch_to_device(
        item.hb, *item.hb.payload(ds.features, ds.labels), device="cpu")
    card = loss_and_grads(host_trainer.params, "gcn", card_batch)
    t0 = time.perf_counter()
    cpu = loss_and_grads(host_trainer.params.to("cpu"), "gcn", cpu_batch)
    cpu_step_s = time.perf_counter() - t0
    loss_diff = abs(card.loss.item() - cpu.loss.item())
    require(loss_diff <= TRAIN_LOSS_ATOL, f"card vs CPU loss: {loss_diff}")
    grad_errs = [rel_err(a, b) for a, b in zip(card.grads, cpu.grads)]
    require(max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"card vs CPU gradients: {grad_errs}")
    del card, cpu, cpu_batch, card_batch
    reset_counts()
    host_steps = []
    for i in range(1, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        item = host_trainer._make_batch(order[i * TRAIN_BATCH:
                                              (i + 1) * TRAIN_BATCH])
        t1 = time.perf_counter()
        batch, nedges = host_trainer._upload(item)
        loss, _ = host_trainer.train_step(batch)
        loss = loss.item()   # syncs
        t2 = time.perf_counter()
        require(np.isfinite(loss), f"host-sampled step loss {loss}")
        host_steps.append({"sample_ms": (t1 - t0) * 1e3,
                           "upload_train_ms": (t2 - t1) * 1e3,
                           "edges": nedges, "loss": loss,
                           "edges_per_s": nedges / (t2 - t0)})
    host_launches = [f.launches for f in k1_fns]
    require(host_launches == [6, 6, 0] and spmm_csr_cuda.launches == 0
            and gat_aggregate_cuda.launches == 0,
            f"host-sampled steps launched {counts()}, expected 2 K1 "
            "forward + 2 dx per step")
    emit({"phase": "train_host", "engine": "GCNSAMPLEGPU",
          "model": "gcn 602-128-41", "fanout": TRAIN_FANOUT,
          "batch": TRAIN_BATCH, "first_batch_loss_abs_diff": loss_diff,
          "loss_atol": TRAIN_LOSS_ATOL, "grad_rel_err": grad_errs,
          "grad_rtol": TRAIN_GRAD_RTOL, "host_cpu_loss_and_grads_s":
          cpu_step_s, "steps": host_steps,
          "k1_launches": dict(zip(("fwd", "dx", "dw"), host_launches))})
    del host_trainer, batch

    # ---- 9. device-sampled training (main path, counted) -------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_loss, tr_acc, edges = dev_trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    train_launches = [f.launches for f in k1_fns]
    val_acc = dev_trainer.evaluate(dev_trainer.val_nids)
    dev_launches = [f.launches for f in k1_fns]
    steps = len(dev_trainer.step_ms)
    eval_batches = -(-dev_trainer.val_nids.size // TRAIN_BATCH)
    losses = dev_trainer.step_losses
    require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
            f"non-finite training loss: {losses}")
    require(steps == 16, f"{steps} steps in the epoch, expected 16")
    require(float(np.mean(losses[-4:])) < losses[0],
            f"loss did not fall: first {losses[0]}, last 4 {losses[-4:]}")
    require(train_launches == [2 * steps, 2 * steps, 0],
            f"training epoch launched K1 {train_launches}")
    require(dev_launches == [2 * steps + 2 * eval_batches, 2 * steps, 0]
            and spmm_csr_cuda.launches == 0
            and gat_aggregate_cuda.launches == 0,
            f"epoch + evaluate launched {counts()}")
    med_step_ms = statistics.median(dev_trainer.step_ms[1:])
    emit({"phase": "train_device", "engine": "GSSAMPLEALLGPU",
          "model": "sage 602-128-41", "fanout": TRAIN_FANOUT,
          "batch": TRAIN_BATCH, "src_pads": list(dev_trainer.src_pads),
          "steps": steps, "step_ms": dev_trainer.step_ms,
          "step_ms_median_after_first": med_step_ms,
          "epoch_s": epoch_s, "edges_per_epoch": edges,
          "sampled_edges_per_s_epoch": edges / epoch_s,
          "sampled_edges_per_s_steady": edges / steps / (med_step_ms / 1e3),
          "overflow": dev_trainer.last_overflow, "losses": losses,
          "train_acc": tr_acc, "val_acc": val_acc,
          "eval_batches": eval_batches,
          "k1_launches": dict(zip(("fwd", "dx", "dw"), dev_launches)),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    del dev_trainer

    # ---- 10. device-sampled GAT training (main path, counted) --------------
    gat_cfg = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=TRAIN_LAYERS,
                        fanout=TRAIN_FANOUT, batch_size=TRAIN_BATCH,
                        learn_rate=0.01, drop_rate=0.5, epochs=1, seed=0,
                        heads=GAT_TRAIN_HEADS, vertices=ds.num_vertices)
    gat_trainer = build_trainer(gat_cfg, ds)
    require(gat_trainer.family == "gat"
            and gat_trainer.weight_kind == WeightKind.NONE
            and gat_trainer.optimizer.bias_correction,
            "GATSAMPLEALLGPU did not build the GAT device trainer")
    # the first batch at drop 0, card against CPU, with seeded nonzero
    # attention vectors (the trainer's own start at zeros, uniform
    # attention, which would leave the scores untested)
    check_params = gat_trainer.params._replace(attn=tuple(
        (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE).to(dev)
        for a in gat_trainer.params.attn))
    batch = first_batch(gat_trainer)
    card = loss_and_grads(check_params, "gat", batch, heads=GAT_TRAIN_HEADS)
    t0 = time.perf_counter()
    cpu = loss_and_grads(check_params.to("cpu"), "gat",
                         batch_to(batch, "cpu"), heads=GAT_TRAIN_HEADS)
    cpu_step_s = time.perf_counter() - t0
    loss_diff = abs(card.loss.item() - cpu.loss.item())
    require(loss_diff <= TRAIN_LOSS_ATOL,
            f"GAT card vs CPU loss: {loss_diff}")
    grad_errs = [rel_err(a, b) for a, b in zip(card.grads, cpu.grads)]
    require(len(grad_errs) == 4 and max(grad_errs) <= TRAIN_GRAD_RTOL,
            f"GAT card vs CPU gradients (W0, W1, a0, a1): {grad_errs}")
    first_loss = card.loss.item()
    del card, cpu, batch
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr_loss, tr_acc, edges = gat_trainer.train_epoch()
    epoch_s = time.perf_counter() - t0
    val_acc = gat_trainer.evaluate(gat_trainer.val_nids)
    gat_train_counts = counts()
    steps = len(gat_trainer.step_ms)
    losses = gat_trainer.step_losses
    require(all(np.isfinite(losses)) and np.isfinite(tr_loss),
            f"non-finite GAT training loss: {losses}")
    require(steps == 16, f"{steps} GAT steps in the epoch, expected 16")
    require(float(np.mean(losses[-4:])) < losses[0],
            f"GAT loss did not fall: first {losses[0]}, last 4 {losses[-4:]}")
    require(not any(gat_train_counts.values()),
            f"sampled GAT launched kernels: {gat_train_counts}")
    med_step_ms = statistics.median(gat_trainer.step_ms[1:])
    emit({"phase": "train_gat", "engine": "GATSAMPLEALLGPU",
          "model": "gat 602-128-41", "heads": GAT_TRAIN_HEADS,
          "fanout": TRAIN_FANOUT, "batch": TRAIN_BATCH,
          "src_pads": list(gat_trainer.src_pads),
          "first_batch_loss": first_loss,
          "first_batch_loss_abs_diff": loss_diff, "loss_atol": TRAIN_LOSS_ATOL,
          "grad_rel_err": grad_errs, "grad_rtol": TRAIN_GRAD_RTOL,
          "host_cpu_loss_and_grads_s": cpu_step_s,
          "steps": steps, "step_ms": gat_trainer.step_ms,
          "step_ms_median_after_first": med_step_ms,
          "epoch_s": epoch_s, "edges_per_epoch": edges,
          "sampled_edges_per_s_epoch": edges / epoch_s,
          "sampled_edges_per_s_steady": edges / steps / (med_step_ms / 1e3),
          "overflow": gat_trainer.last_overflow, "losses": losses,
          "train_acc": tr_acc, "val_acc": val_acc,
          "launches": gat_train_counts,
          "peak_mem_gb_epoch": torch.cuda.max_memory_allocated() / 1e9})
    del gat_trainer

    # ---- 11. K2's backward against its plain version -----------------------
    def skewed_rows(n_rows, n_src, no_out_every):
        """A skewed CSR (hub rows, every 13th row without edges) whose
        sources `no_out_every` apart have no out-edges, and whose source 5
        takes every 80th edge: a hub row of the transposed CSR, longer than
        LONG_ROW_EDGES (the kernels split it across warps)."""
        deg = (torch.rand(n_rows, generator=gen) ** 4 * 120).long()
        deg[::13] = 0
        deg[:4] = 6000
        rowptr_ = torch.zeros(n_rows + 1, dtype=torch.int64)
        rowptr_[1:] = deg.cumsum(0)
        col_ = torch.randint(0, n_src, (int(rowptr_[-1]),), generator=gen,
                             dtype=torch.int32)
        col_ = torch.where(col_ % no_out_every == 3, col_ - 1, col_)
        col_[::80] = 5
        return rowptr_, col_

    def transposed(rowptr_, col_, w_, n_src):
        return [torch.from_numpy(a).to(dev) for a in csr_transpose(
            rowptr_.cpu().numpy(), col_.cpu().numpy(), w_.cpu().numpy(),
            n_src)]

    k2b_checks = []
    for feat in (7, 41, 128, 256):
        for dt in (torch.float32, torch.bfloat16):
            n_rows = n_src = 20000
            rowptr_, col_ = skewed_rows(n_rows, n_src, 11)
            w_ = torch.randn(col_.numel(), generator=gen)
            csr_t = transposed(rowptr_, col_, w_, n_src)
            g = torch.randn(n_rows, feat, generator=gen).to(dev, dt)
            out = spmm_csr_bwd_cuda(g, *csr_t)
            again = spmm_csr_bwd_cuda(g, *csr_t)
            torch.cuda.synchronize()
            err = rel_err(out, spmm_csr_plain(*exact_ref(g, *csr_t)))
            key = str(dt).removeprefix("torch.")
            k2b_checks.append({"F": feat, "dtype": key,
                               "E": col_.numel(), "rel_err": err,
                               "tol": TOL[key]})
            require(err <= TOL[key], f"K2 bwd vs plain F={feat} {key}: "
                                     f"{err} > {TOL[key]}")
            require(bool((out[3::11] == 0).all()),
                    "K2 bwd: sources with no out-edges are not zero")
            require(torch.equal(out, again), "K2 bwd is not deterministic")

    # the whole Reddit-shaped graph's transposed CSR, GCN weights (the
    # GCNFULLBATCH backward's)
    src_h, _, w_h = build_coo(adj, WeightKind.GCN)
    t0 = time.perf_counter()
    rowptr_th, col_th, w_th = csr_transpose(adj.indptr, src_h, w_h, v)
    transpose_s = time.perf_counter() - t0
    max_row = int(np.diff(rowptr_th).max())
    r_t, c_t, w_t = (torch.from_numpy(a).to(dev)
                     for a in (rowptr_th, col_th, w_th))
    lib_csr_t = torch.sparse_csr_tensor(r_t, c_t.long(), w_t, size=(v, v))
    k2b_shapes = []
    for feat in (128, 41):
        g = torch.randn(v, feat, generator=gen).to(dev)
        out = spmm_csr_bwd_cuda(g, r_t, c_t, w_t)
        ref = spmm_csr_plain(g, r_t, c_t, w_t)
        torch.cuda.synchronize()
        err = rel_err(out, ref)
        require(err <= TOL["float32"], f"K2 bwd vs plain at the training "
                                       f"shape F={feat}: {err}")
        once = e * 8 + 8 * (v + 1) + 2 * v * feat * 4
        flops = 2 * e * feat
        k2b_shapes.append({
            "F": feat, "dtype": "float32", "V": v, "E": e,
            "max_row": max_row,
            "max_abs_err": (out - ref).abs().max().item(), "rel_err": err,
            "tol": TOL["float32"],
            "ms": time_ms(lambda: spmm_csr_bwd_cuda(g, r_t, c_t, w_t), 20),
            "plain_ms": time_ms(lambda: spmm_csr_plain(g, r_t, c_t, w_t), 3),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib_csr_t, g), 20),
            "bound_ms": max(once / hbm, flops / F32_FLOPS_PER_S) * 1e3,
            "bound_by": ("bytes" if once / hbm >= flops / F32_FLOPS_PER_S
                         else "operations"),
            "gather_bound_ms": (e * 8 + 8 * (v + 1) + e * feat * 4
                                + v * feat * 4) / hbm * 1e3})
        del out, ref
    del lib_csr_t
    emit({"phase": "kernel_k2_bwd", "checks": k2b_checks,
          "training_shapes": k2b_shapes, "csr_transpose_s": transpose_s})

    # ---- 12. K4 against its plain versions ---------------------------------
    def k4_bounds(feat, heads, b):
        """(B1, B2) as (bytes, operations), each input read once and each
        output written once; per (edge, head) ~10 operations for the score,
        leaky_relu, the clip, exp and q."""
        common = 16 * heads * v + 8 * (v + 1) + 4 * e
        return ((v * feat * (b + 8) + common, 4 * e * feat + 10 * e * heads),
                (v * feat * (b + 4) + common, 2 * e * feat + 10 * e * heads))

    k4_checks = []
    for heads, feat in K3_GRID:
        for dt in (torch.float32, torch.bfloat16):
            n_dst = 20000
            n_src = 15000 if (heads, feat) == (4, 128) else n_dst
            rowptr_, col_ = skewed_rows(n_dst, n_src, 17)
            ht = torch.randn(n_src, feat, generator=gen).to(dev, dt)
            ts, td = k3_tables(ht, torch.randn(n_dst, feat, generator=gen)
                               .to(dev, dt), heads, K3_SCORE_STD)
            ts[::K3_CLIP_EVERY] += K3_CLIP_RAISE
            gz = torch.randn(n_dst, feat, generator=gen).to(dev)
            rz = torch.randn(n_dst, heads, generator=gen).to(dev)
            rowptr_, col_ = rowptr_.to(dev), col_.to(dev)
            r_t4, c_t4, _ = transposed(rowptr_, col_, torch.ones(
                col_.numel()), n_src)
            b1 = (ht, ts, gz, td, rz, r_t4, c_t4, heads)
            b2 = (ht, ts, gz, td, rz, rowptr_, col_, heads)
            dht, dts = gat_bwd_src_cuda(*b1)
            dtd = gat_bwd_dst_cuda(*b2)
            again = (*gat_bwd_src_cuda(*b1), gat_bwd_dst_cuda(*b2))
            torch.cuda.synchronize()
            ref_dht, ref_dts = gat_bwd_src_plain(*exact_ref(*b1))
            ref_dtd = gat_bwd_dst_plain(*exact_ref(*b2))
            key = str(dt).removeprefix("torch.")
            errs = {"dht_agg": rel_err(dht, ref_dht),
                    "dts": rel_err(dts, ref_dts),
                    "dtd": rel_err(dtd, ref_dtd)}
            k4_checks.append({"H": heads, "F": feat, "dtype": key,
                              "S": n_src, "D": n_dst, "E": col_.numel(),
                              "rel_err": errs, "tol": TOL[key],
                              "table_tol": K4_TABLE_TOL})
            require(errs["dht_agg"] <= TOL[key]
                    and errs["dts"] <= K4_TABLE_TOL
                    and errs["dtd"] <= K4_TABLE_TOL,
                    f"K4 vs plain H={heads} F={feat} {key}: {errs}")
            require(bool((dtd[::13][1:] == 0).all())
                    and bool((dht[3::17] == 0).all())
                    and bool((dts[3::17] == 0).all()),
                    "K4: rows with no edges are not zero")
            require(all(torch.equal(a, b) for a, b in
                        zip((dht, dts, dtd), again)),
                    "K4 is not deterministic")
            del ref_dht, ref_dts, ref_dtd

    k4_shapes = []
    for feat, heads in ((128, 4), (128, 1), (41, 1)):
        ht = torch.randn(v, feat, generator=gen).to(dev)
        ts, td = k3_tables(ht, ht, heads, 2.0)
        gz = torch.randn(v, feat, generator=gen).to(dev)
        rz = torch.randn(v, heads, generator=gen).to(dev)
        b1 = (ht, ts, gz, td, rz, r_t, c_t, heads)
        b2 = (ht, ts, gz, td, rz, g_rowptr, g_col, heads)
        got = (*gat_bwd_src_cuda(*b1), gat_bwd_dst_cuda(*b2))
        ref = (*gat_bwd_src_plain(*b1), gat_bwd_dst_plain(*b2))
        torch.cuda.synchronize()
        errs = [rel_err(a, r) for a, r in zip(got, ref)]
        require(errs[0] <= TOL["float32"] and max(errs[1:]) <= K4_TABLE_TOL,
                f"K4 vs plain at the training shape F={feat} H={heads}: "
                f"{errs}")
        comp_ms = None
        if heads == 1:
            # a yardstick only (no single PyTorch call computes K4): the
            # backward of K3's function composed of torch ops under
            # autograd.  Not k3_composition's: the gradient of
            # torch.sparse.mm with respect to the CSR's values asks for a
            # dense [V, V] buffer (202 GiB here); so K3's plain version,
            # edge gathers, exp and index_add_ in chunks
            leaves = [t.detach().requires_grad_() for t in (ht, ts, td)]
            out, _ = gat_aggregate_plain(*leaves, g_rowptr, g_col, heads)
            cot = torch.randn(v, feat, generator=gen).to(dev)
            comp_ms = time_ms(lambda: torch.autograd.grad(
                out, leaves, cot, retain_graph=True), 3)
            del out, leaves, cot
        for kname, fn, plain, (nbytes, ops), got_i, ref_i in (
                ("gat_bwd_src", lambda: gat_bwd_src_cuda(*b1),
                 lambda: gat_bwd_src_plain(*b1), k4_bounds(feat, heads, 4)[0],
                 got[:2], ref[:2]),
                ("gat_bwd_dst", lambda: gat_bwd_dst_cuda(*b2),
                 lambda: gat_bwd_dst_plain(*b2), k4_bounds(feat, heads, 4)[1],
                 got[2:], ref[2:])):
            k4_shapes.append({
                "name": kname, "F": feat, "H": heads, "dtype": "float32",
                "V": v, "E": e,
                "max_row": max_row,
                "max_abs_err": max((a - r).abs().max().item()
                                   for a, r in zip(got_i, ref_i)),
                "rel_err": [rel_err(a, r) for a, r in zip(got_i, ref_i)],
                "tol": [TOL["float32"], K4_TABLE_TOL],
                "ms": time_ms(fn, 20), "plain_ms": time_ms(plain, 3),
                "library_ms": None,
                "composition_bwd_ms": comp_ms,
                "bound_ms": max(nbytes / hbm, ops / F32_FLOPS_PER_S) * 1e3,
                "bound_by": ("bytes" if nbytes / hbm >= ops / F32_FLOPS_PER_S
                             else "operations"),
                "gather_bound_ms": (nbytes + e * feat * 4) / hbm * 1e3})
        del got, ref
    emit({"phase": "kernel_k4", "checks": k4_checks,
          "training_shapes": k4_shapes,
          "library": "none: no single PyTorch call computes K4; "
                     "composition_bwd_ms times the backward of K3's plain "
                     "version (torch ops) under autograd (H=1, f32), once "
                     "per shape, beside both passes"})
    del r_t, c_t, w_t

    # ---- 13. whole-graph training (main path, counted) ---------------------
    def full_cfg(algo, heads, n_vertices, drop):
        return RunConfig(algorithm=algo, layer_sizes=TRAIN_LAYERS,
                         learn_rate=0.01, drop_rate=drop, epochs=FULL_EPOCHS,
                         seed=0, heads=heads, vertices=n_vertices)

    def full_loss_and_grads(base, params, branches, replay):
        """The first epoch's loss and gradients.  relu's subgradient jumps
        at 0, and among the ~1e7 hidden pre-activations a few lie within
        f32 rounding of it: the card and the CPU may take its two sides
        there, and one such element moves dW0 by ~1e-4 of its largest
        entry.  So the card's run records the side every torch.relu call
        takes on every element (`branches`), and the CPU's run replays
        those sides (`replay`): both then differentiate the same piecewise
        linear function.  Returns the loss, the gradients and how many
        elements the replay moved to the card's side."""
        real_relu = torch.relu
        moved = [0]
        sides = iter(branches)

        def relu(t):
            if not replay:
                branches.append((t > 0).detach().cpu())
                return real_relu(t)
            keep = next(sides).to(t.device)
            moved[0] += int(((t > 0) != keep).sum())
            return torch.where(keep, t, torch.zeros((), dtype=t.dtype,
                                                    device=t.device))

        leaves = [p.detach().to(base.device).requires_grad_()
                  for p in params.leaves()]
        torch.relu = relu
        try:
            logp = base.forward(params.replace_leaves(leaves), train=True)
        finally:
            torch.relu = real_relu
        loss = nll_loss_masked(logp, base.y, base.masks[0])
        loss.backward()
        return loss.item(), [t.grad for t in leaves], moved[0]

    small = reddit_like_dataset(seed=0, scale=FULL_EXACT_SCALE)
    full_exact = []
    for algo, heads in FULL_ENGINES:
        cfg = full_cfg(algo, heads, small.num_vertices, 0.0)
        card_tr = build_trainer(cfg, small).base
        check_params = card_tr.params._replace(attn=tuple(
            (torch.randn(a.shape, generator=attn_gen) * GAT_ATTN_SCALE)
            .to(dev) for a in card_tr.params.attn))
        branches = []
        card_loss, card_grads, _ = full_loss_and_grads(
            card_tr, check_params, branches, replay=False)
        t0 = time.perf_counter()
        cpu_loss, cpu_grads, moved = full_loss_and_grads(
            build_trainer(cfg, small, device="cpu").base,
            check_params.to("cpu"), branches, replay=True)
        cpu_s = time.perf_counter() - t0
        loss_diff = abs(card_loss - cpu_loss)
        grad_errs = [rel_err(a, b) for a, b in zip(card_grads, cpu_grads)]
        require(loss_diff <= TRAIN_LOSS_ATOL,
                f"{algo} card vs CPU loss: {loss_diff}")
        require(len(grad_errs) == (4 if algo == "GATFULLBATCH" else 2)
                and max(grad_errs) <= TRAIN_GRAD_RTOL,
                f"{algo} card vs CPU gradients: {grad_errs}")
        full_exact.append({"engine": algo, "heads": heads,
                           "V": small.num_vertices,
                           "E": card_tr.adj.num_edges, "loss": card_loss,
                           "loss_abs_diff": loss_diff,
                           "grad_rel_err": grad_errs,
                           "relu_sides_replayed": moved,
                           "relu_elements": sum(b.numel() for b in branches),
                           "host_cpu_loss_and_grads_s": cpu_s})
        del card_tr, card_grads, cpu_grads, branches
    del small

    per_epoch = {"GCNFULLBATCH": {"spmm_csr": 4, "spmm_csr_bwd": 2},
                 "GSFULLBATCH": {"spmm_csr": 4, "spmm_csr_bwd": 2},
                 "GATFULLBATCH": {"gat_aggregate": 4, "gat_bwd_src": 2,
                                  "gat_bwd_dst": 2}}
    per_predict = {"GCNFULLBATCH": {"spmm_csr": 2},
                   "GSFULLBATCH": {"spmm_csr": 2},
                   "GATFULLBATCH": {"gat_aggregate": 2}}
    full_runs = []
    reset_counts()
    for algo, heads in FULL_ENGINES:
        t0 = time.perf_counter()
        base = build_trainer(full_cfg(algo, heads, ds.num_vertices, 0.5),
                             ds).base
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        hist = []
        for _ in range(FULL_EPOCHS):
            before = counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, tr_acc, va_acc, te_acc = base.train_epoch()
            torch.cuda.synchronize()
            hist.append({"ms": (time.perf_counter() - t0) * 1e3,
                         "loss": loss, "train": tr_acc, "val": va_acc,
                         "test": te_acc})
            now = counts()
            got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
            require(got == per_epoch[algo],
                    f"{algo} epoch launched {got}, expected {per_epoch[algo]}")
        before = counts()
        pred = base.predict()
        now = counts()
        got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
        require(got == per_predict[algo],
                f"{algo} predict() launched {got}")
        require(pred.shape == (v, 41) and bool(np.isfinite(pred).all()),
                f"{algo} predict() shape {pred.shape} or non-finite values")
        losses = [h["loss"] for h in hist]
        require(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
                f"{algo} losses not finite or not falling: {losses}")
        med_ms = statistics.median(h["ms"] for h in hist[1:])
        full_runs.append({
            "engine": algo, "heads": heads, "V": v,
            "E": base.adj.num_edges, "drop": 0.5, "epochs": hist,
            "epoch_ms_median_after_first": med_ms,
            "edges_per_s": base.adj.num_edges / (med_ms / 1e3),
            "build_s": base.build_s, "csr_transpose_s": base.transpose_s,
            "build_trainer_s": build_s,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        del base, pred
    full_counts = counts()
    for kname in ("spmm_csr_bwd", "gat_bwd_src", "gat_bwd_dst"):
        require(full_counts[kname] > 0, f"train_full never launched {kname}")
    require(all(full_counts[k] == 0 for k in (
        "gather_agg_fwd", "gather_agg_bwd_dx", "gather_agg_bwd_dw")),
            f"whole-graph training launched K1: {full_counts}")
    emit({"phase": "train_full", "model": "602-128-41",
          "loss_atol": TRAIN_LOSS_ATOL, "grad_rtol": TRAIN_GRAD_RTOL,
          "exact_scale": FULL_EXACT_SCALE, "exact": full_exact,
          "runs": full_runs, "launches": full_counts})

    # ---- 14. kernels --------------------------------------------------------
    # one logprobs() pass's work: the F=128 and the F=41 f32 SpMMs
    per_pass = [t for t in timings if t["dtype"] == "float32"]

    def total(rows, k):
        vals = [t[k] for t in rows]
        return None if None in vals else sum(vals)

    def line(name, rows, source, replaces, n, what):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(t["max_abs_err"] for t in rows),
                "ms": total(rows, "ms"), "plain_ms": total(rows, "plain_ms"),
                "bound_ms": total(rows, "bound_ms"),
                "bound_by": ("bytes" if all(t["bound_by"] == "bytes"
                                            for t in rows) else "operations"),
                "library_ms": total(rows, "library_ms"), "shapes": what}

    step_shapes = ("one training step's two layers: (D, K, S, F) = " + ", ".join(
        f"({t['D']}, {t['K']}, {t['S']}, {t['F']})" for t in k1_shapes
        if t["name"] == "gather_agg_fwd"))
    kernels = [line("spmm_csr", per_pass, "sgnn_tpu_torch/csrc/spmm.cu",
                    "sgnn_tpu/ops/pallas/mxu_spmm.py:316", launches,
                    f"one f32 logprobs pass: F=128 + F=41 on the {v}-vertex, "
                    f"{e}-edge graph")]
    for kname, replaces, n in (
            ("gather_agg_fwd", "sgnn_tpu/ops/pallas/gather_agg.py:43",
             dev_launches[0]),
            ("gather_agg_bwd_dx", "sgnn_tpu/ops/aggregate.py:60",
             dev_launches[1]),
            ("gather_agg_bwd_dw", "sgnn_tpu/ops/aggregate.py:60",
             dev_launches[2])):
        kernels.append(line(kname, [t for t in k1_shapes
                                    if t["name"] == kname],
                            "sgnn_tpu_torch/csrc/gather_agg.cu", replaces, n,
                            step_shapes))
    # one single-head f32 GAT logprobs pass: F=128 + F=41, both at H=1
    k3_pass = [t for t in k3_shapes
               if t["dtype"] == "float32" and t["H"] == 1]
    k3_line = line("gat_aggregate", k3_pass, "sgnn_tpu_torch/csrc/gat.cu",
                   "sgnn_tpu/ops/pallas/mxu_gat.py:182", gat_launches,
                   f"one f32 single-head GAT logprobs pass: F=128 + F=41 on "
                   f"the {v}-vertex, {e}-edge graph (library_ms null: no "
                   f"single PyTorch call computes K3; composition_ms is "
                   f"scores + torch.sparse.mm + z)")
    k3_line["composition_ms"] = total(k3_pass, "composition_ms")
    kernels.append(k3_line)
    kernels.append(line(
        "spmm_csr_bwd", k2b_shapes, "sgnn_tpu_torch/csrc/spmm.cu",
        "sgnn_tpu/ops/pallas/mxu_spmm.py:463", full_counts["spmm_csr_bwd"],
        f"one GCN/GSFULLBATCH epoch's backward: F=128 + F=41 f32 on the "
        f"{v}-vertex, {e}-edge graph's transposed CSR"))
    # one GATFULLBATCH (heads 4) epoch's backward: F=128 H=4 + F=41 H=1
    for kname, replaces in (("gat_bwd_src", "sgnn_tpu/ops/pallas/mxu_gat.py:431"),
                            ("gat_bwd_dst", "sgnn_tpu/ops/pallas/mxu_gat.py:431")):
        rows = [t for t in k4_shapes if t["name"] == kname
                and (t["F"], t["H"]) in ((128, GAT_TRAIN_HEADS), (41, 1))]
        k4_line = line(kname, rows, "sgnn_tpu_torch/csrc/gat_bwd.cu",
                       replaces, full_counts[kname],
                       f"one GATFULLBATCH heads-{GAT_TRAIN_HEADS} epoch's "
                       f"backward: F=128 H={GAT_TRAIN_HEADS} + F=41 H=1 f32 "
                       f"on the {v}-vertex, {e}-edge graph (library_ms "
                       f"null: no single PyTorch call computes K4; "
                       f"composition_ms is the backward of K3's plain "
                       f"version under autograd at F=128 + F=41, H=1)")
        k4_line["composition_ms"] = total(
            [t for t in k4_shapes if t["name"] == kname and t["H"] == 1],
            "composition_bwd_ms")
        kernels.append(k4_line)
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
