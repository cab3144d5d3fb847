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
4. serving   — GCN 602-128-41 (seed-0 weights) on `reddit_like_dataset(seed=0,
               scale=1.0)` through `InferenceServer.logprobs()`: f32 pass
               time, two kernel launches per pass, agreement with the port's
               CPU pass, then a bf16 server's pass time, its log-probs held to
               the f32 pass within 0.05 and its argmax agreement;
5. queries   — `query(nids)` for requests of 8, 64 and 512 vertices, each
               held to the whole-graph rows, with p50 latency per size;
6. train_host   — GCNSAMPLEGPU (host sampler), GCN 602-128-41, fanout 25-10,
               batch 10000: the first batch's loss and weight gradients on
               the card held to the port's CPU on the same blocks and
               parameters (drop 0), then 3 training steps (drop 0.5), with
               per-step time and sampled edges/s;
7. train_device — GSSAMPLEALLGPU (device sampler) at the same widths: one
               whole epoch (16 steps) and `evaluate` on the validation
               vertices; finite losses, the last 4 steps' mean loss below
               the first step's, K1 launched 2 forward + 2 dx per step and 2
               forward per eval batch; per-step median time, sampled
               edges/s, overflow count and train accuracy;
8. kernels   — one line listing every kernel with its launches on its main
               path (serving for `spmm_csr`, train_device for K1), its error
               and its times.

Then the card's name and power limit as nvidia-smi prints them, and last
`{"ok": true, "device": {...}}`.  Any failed check raises and the script
exits non-zero; nothing falls back to the CPU or to a plain version.  With
no CUDA device it exits 1 and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

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
# bf16 — both sum in f32 and round once to bf16 at the end, so the
# results differ by at most about one bf16 ulp (2^-8 relative) of an
# element; the repo's bf16 kernel bound (tests/test_mxu_spmm.py:57).
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
    from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_cuda
    from sgnn_tpu_torch.ops.segment import spmm_csr_plain
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
            ref = spmm_csr_plain(*args)
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
            ref = spmm_csr_plain(x, rowptr, col, w)
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
                    "fwd": rel_err(out, agg.gather_aggregate_plain(x, nbr, w)),
                    "dx": rel_err(dx, agg.gather_agg_bwd_dx_plain(
                        g, nbr, w, s_chk, dt)),
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
    seeds = torch.zeros(dev_trainer.seed_pad, dtype=torch.int32)
    seeds[:TRAIN_BATCH] = torch.from_numpy(dev_trainer.train_nids[
        :TRAIN_BATCH].astype(np.int32))
    sample = device_sample_batch(
        torch.Generator(device=dev).manual_seed(1), seeds.to(dev),
        (torch.arange(dev_trainer.seed_pad) < TRAIN_BATCH).to(dev),
        dev_trainer.dev_indptr, dev_trainer.dev_indices,
        dev_trainer.dev_in_deg, dev_trainer.dev_out_deg,
        dev_trainer.dev_features, dev_trainer.dev_labels,
        tuple(TRAIN_FANOUT), dev_trainer.src_pads,
        dev_trainer.weight_kind, degree_mode=dev_trainer.dev_degree_mode)
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

    # ---- 4. serving at full width (main path, counted) ----------------------
    spmm_csr_cuda.launches = 0
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

    # ---- 5. per-request queries (main path, counted) ------------------------
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
    launches = spmm_csr_cuda.launches
    require(launches > 0, "the main path never launched spmm_csr")
    emit({"phase": "queries", "max_abs_diff": q_err, "tol": SERVE_ATOL,
          "p50_ms": {str(s): statistics.median(t) * 1e3
                     for s, t in lat.items()}})

    # ---- 6. host-sampled training (main path, counted) ---------------------
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
    for f in (spmm_csr_cuda, *k1_fns):
        f.launches = 0
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
    require(host_launches == [6, 6, 0] and spmm_csr_cuda.launches == 0,
            f"host-sampled steps launched K1 {host_launches}, expected 2 "
            "forward + 2 dx per step")
    emit({"phase": "train_host", "engine": "GCNSAMPLEGPU",
          "model": "gcn 602-128-41", "fanout": TRAIN_FANOUT,
          "batch": TRAIN_BATCH, "first_batch_loss_abs_diff": loss_diff,
          "loss_atol": TRAIN_LOSS_ATOL, "grad_rel_err": grad_errs,
          "grad_rtol": TRAIN_GRAD_RTOL, "host_cpu_loss_and_grads_s":
          cpu_step_s, "steps": host_steps,
          "k1_launches": dict(zip(("fwd", "dx", "dw"), host_launches))})
    del host_trainer, batch

    # ---- 7. device-sampled training (main path, counted) -------------------
    for f in (spmm_csr_cuda, *k1_fns):
        f.launches = 0
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
            and spmm_csr_cuda.launches == 0,
            f"epoch + evaluate launched K1 {dev_launches}")
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

    # ---- 8. kernels ---------------------------------------------------------
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
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
