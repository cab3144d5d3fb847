#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `sgnn_tpu_torch/csrc/` (nvcc, into
`build/torch_kernels/`), then runs these phases, printing one JSON line each:

1. build   — nvcc time per kernel, and the card's name and power limit;
2. kernel  — `spmm_csr` (the kernel) against `spmm_csr_plain` on the same
             CUDA tensors, on skewed random CSR graphs at F in {7, 41, 128,
             256}, f32 and bf16; then, at the Reddit-shaped serving shapes
             (F=128 and 41, f32 and bf16), the kernel held to the plain
             version at the same tolerances and timed beside it, one library call
             (`torch.sparse.mm`, timed here only, never called by the port)
             and the bound (bytes over HBM bandwidth, flops over f32 rate);
3. serving — GCN 602-128-41 (seed-0 weights) on `reddit_like_dataset(seed=0,
             scale=1.0)` through `InferenceServer.logprobs()`: f32 pass time,
             two kernel launches per pass, agreement with the port's CPU pass,
             then a bf16 server's pass time, its log-probs held to the f32
             pass within 0.05 and its argmax agreement;
4. queries — `query(nids)` for requests of 8, 64 and 512 vertices, each held
             to the whole-graph rows, with p50 latency per size;
5. kernels — one line listing every kernel with its launches on the main
             path (phases 3 and 4), its error and its times.

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
    from sgnn_tpu_torch.data.synthetic import reddit_like_dataset
    from sgnn_tpu_torch.graph.adjacency import Adjacency
    from sgnn_tpu_torch.models.gnn import init_model
    from sgnn_tpu_torch.ops.cuda.build import build_all
    from sgnn_tpu_torch.ops.cuda.spmm import spmm_csr_cuda
    from sgnn_tpu_torch.ops.segment import spmm_csr_plain
    from sgnn_tpu_torch.train.inference import InferenceServer

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
        return ((got.float() - ref).abs().max()
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

    # ---- 3. serving at full width (main path, counted) ----------------------
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

    # ---- 4. per-request queries (main path, counted) ------------------------
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

    # ---- 5. kernels ---------------------------------------------------------
    # one logprobs() pass's work: the F=128 and the F=41 f32 SpMMs
    per_pass = [t for t in timings if t["dtype"] == "float32"]

    def total(k):
        return sum(t[k] for t in per_pass)

    ms = total("ms")
    emit({"kernels": [{
        "name": "spmm_csr", "route": "cuda",
        "source": "sgnn_tpu_torch/csrc/spmm.cu",
        "replaces": "sgnn_tpu/ops/pallas/mxu_spmm.py:316",
        "launches": launches,
        "max_abs_err": max(t["max_abs_err"] for t in per_pass),
        "ms": ms, "kernel_ms": ms, "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": ("bytes" if all(t["bound_by"] == "bytes"
                                    for t in per_pass) else "operations"),
        "library_ms": total("library_ms"),
        "shapes": "one f32 logprobs pass: F=128 + F=41 on the "
                  f"{v}-vertex, {e}-edge graph"}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
