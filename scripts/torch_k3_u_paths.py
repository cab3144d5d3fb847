#!/usr/bin/env python3
"""K3's two ways of computing the attention weights u, timed side by side.

    python3 scripts/torch_k3_u_paths.py [--scale 1.0] [--reps 20]

K3 (`sgnn_tpu_torch/csrc/gat.cu`) computes u = exp(clip(leaky_relu(ts[src] +
td[dst]))) once per (edge, head) of a column tile: lane k of a warp computes
edge k's u for the tile's heads into shared memory, and every lane reads it
there.  The other design is "per lane": every lane computes u for its own
columns' heads from the score tables, one expf per (edge, column), with no
shared memory.  This script holds that variant in its own CUDA source
(`PER_LANE_SRC` below; it is not part of the port), builds it with the
port's nvcc flags, and times it beside the port's kernel on the Reddit-shaped
whole-graph CSR (`reddit_like_dataset(seed=0, scale)`, ones as weights) at
GAT serving's shapes (F=128 at H=1 and 4, F=41 at H=1) and at (H, F) =
(16, 256), where a column tile of the port's kernel spans 8 heads and the
row is walked twice, in f32 and bf16.  Each pair is held to each other
(relative max-abs 1e-5 f32, 5e-3 bf16) and timed with CUDA events in the
order port, per-lane, per-lane, port, `--reps` launches each.  Prints one
JSON line per shape, ptxas's registers for both builds, and the card's name
and power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.graph.adjacency import Adjacency  # noqa: E402
from sgnn_tpu_torch.ops.cuda.build import (  # noqa: E402
    BUILD_DIR, CSRC_DIR, NVCC_FLAGS, build, find_nvcc,
)
from sgnn_tpu_torch.ops.cuda.gat import gat_aggregate_cuda  # noqa: E402
from sgnn_tpu_torch.ops.gat import pack_score_tables  # noqa: E402
from sgnn_tpu_torch.ops.segment import (  # noqa: E402
    DTYPE_CODES, csr_from_numpy,
)

SHAPES = ((128, 1), (128, 4), (41, 1), (256, 16))
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}

# The per-lane u variant: the port's kernel with the shared buffer taken
# out and each lane's u computed from the tables; tiles of 32*COLS columns.
PER_LANE_SRC = r"""
#include <cfloat>
#include "common.cuh"
namespace {
using sgnn::from_float; using sgnn::kFullMask; using sgnn::kWarpsPerBlock;
using sgnn::to_float;
__device__ __forceinline__ float attention_exp(float s) {
  s = s >= 0.0f ? s : 0.2f * s;
  return expf(fminf(fmaxf(s, -60.0f), 60.0f));
}
template <typename T, int COLS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
per_lane_kernel(const T* __restrict__ ht, const float* __restrict__ ts,
                const float* __restrict__ td, const int64_t* __restrict__ rowptr,
                const int32_t* __restrict__ col, T* __restrict__ out,
                float* __restrict__ z, int64_t num_rows, int64_t feat,
                int heads) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t fh = feat / heads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t row = first; row < num_rows; row += stride) {
    const int64_t beg = rowptr[row], end = rowptr[row + 1];
    const float* td_row = td + row * heads;
    for (int64_t c0 = 0; c0 < feat; c0 += 32 * COLS) {
      int head[COLS];
      float td_col[COLS], acc[COLS], zacc[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        head[j] = c < feat ? static_cast<int>(c / fh) : 0;
        td_col[j] = td_row[head[j]];
        acc[j] = 0.0f;
        zacc[j] = 0.0f;
      }
      for (int64_t e0 = beg; e0 < end; e0 += 32) {
        const int n = static_cast<int>(min(static_cast<int64_t>(32), end - e0));
        const int my_col = lane < n ? col[e0 + lane] : 0;
        for (int k = 0; k < n; ++k) {
          const int src = __shfl_sync(kFullMask, my_col, k);
          const T* x_row = ht + static_cast<int64_t>(src) * feat;
          const float* ts_row = ts + static_cast<int64_t>(src) * heads;
#pragma unroll
          for (int j = 0; j < COLS; ++j) {
            const int64_t c = c0 + lane + 32 * j;
            if (c < feat) {
              const float u = attention_exp(ts_row[head[j]] + td_col[j]);
              acc[j] = fmaf(u, to_float(x_row[c]), acc[j]);
              zacc[j] += u;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int64_t c = c0 + lane + 32 * j;
        if (c < feat) {
          out[row * feat + c] = from_float<T>(acc[j] / fmaxf(zacc[j], FLT_MIN));
          if (c % fh == 0) z[row * heads + head[j]] = zacc[j];
        }
      }
    }
  }
}
template <typename T, int COLS>
void go(const void* ht, const void* ts, const void* td, const void* rp,
        const void* cp, void* out, void* z, int64_t n, int64_t f, int h,
        cudaStream_t s) {
  per_lane_kernel<T, COLS><<<sgnn::warp_blocks(n), kWarpsPerBlock * 32, 0, s>>>(
      static_cast<const T*>(ht), static_cast<const float*>(ts),
      static_cast<const float*>(td), static_cast<const int64_t*>(rp),
      static_cast<const int32_t*>(cp), static_cast<T*>(out),
      static_cast<float*>(z), n, f, h);
}
template <typename T>
void pick(const void* ht, const void* ts, const void* td, const void* rp,
          const void* cp, void* out, void* z, int64_t n, int64_t f, int h,
          cudaStream_t s) {
  if (f <= 32) go<T, 1>(ht, ts, td, rp, cp, out, z, n, f, h, s);
  else if (f <= 64) go<T, 2>(ht, ts, td, rp, cp, out, z, n, f, h, s);
  else if (f <= 128) go<T, 4>(ht, ts, td, rp, cp, out, z, n, f, h, s);
  else go<T, 8>(ht, ts, td, rp, cp, out, z, n, f, h, s);
}
}  // namespace
extern "C" int k3_per_lane_u(const void* ht, const void* ts, const void* td,
                             const void* rp, const void* cp, void* out,
                             void* z, long long n, long long f, int h,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) pick<float>(ht, ts, td, rp, cp, out, z, n, f, h, s);
  else pick<__nv_bfloat16>(ht, ts, td, rp, cp, out, z, n, f, h, s);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_per_lane():
    """nvcc the variant with the port's flags; (ctypes function, ptxas log)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + PER_LANE_SRC.encode())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"k3_per_lane_u-{h.hexdigest()[:16]}.cu"
    lib = src.with_suffix(".so")
    src.write_text(PER_LANE_SRC)
    res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC_DIR),
                          "-o", str(lib), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed for the per-lane variant:\n"
                           + res.stdout + res.stderr)
    fn = ctypes.CDLL(str(lib)).k3_per_lane_u
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def registers(log: str):
    return [ln.strip() for ln in log.splitlines() if "registers" in ln]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_u_paths: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    per_lane, per_lane_log = build_per_lane()
    port_log = build("gat").log
    ds = reddit_like_dataset(seed=0, scale=args.scale)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    v = adj.num_vertices
    csr = csr_from_numpy(adj.indptr, adj.indices.astype(np.int32),
                         np.ones(adj.indices.size, np.float32), v, dev)
    gen = torch.Generator().manual_seed(3)

    def run_per_lane(ht, ts, td, heads):
        out = torch.empty_like(ht)
        z = torch.empty((v, heads), dtype=torch.float32, device=dev)
        rc = per_lane(ht.data_ptr(), ts.data_ptr(), td.data_ptr(),
                      csr.rowptr.data_ptr(), csr.col.data_ptr(),
                      out.data_ptr(), z.data_ptr(), v, ht.shape[1], heads,
                      DTYPE_CODES[ht.dtype],
                      torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"per-lane variant launch failed: {rc}")
        return out, z

    def time_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    for feat, heads in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            ht = torch.randn(v, feat, generator=gen).to(dev, dt)
            a = (torch.randn(2, feat, generator=gen)
                 * (2.0 / (feat // heads) ** 0.5)).to(dev)
            ts, td = pack_score_tables(ht, a[0], a[1], heads)

            def port():
                return gat_aggregate_cuda(ht, ts, td, csr.rowptr, csr.col,
                                          heads)

            def lane():
                return run_per_lane(ht, ts, td, heads)

            (h0, z0), (h1, z1) = port(), lane()
            err = ((h0.float() - h1.float()).abs().max()
                   / h1.float().abs().max()).item()
            zerr = ((z0 - z1).abs() / z1.abs().clamp_min(1e-30)).max().item()
            if err > TOL[dt] or zerr > TOL[torch.float32]:
                raise RuntimeError(f"F={feat} H={heads} {dt}: the variants "
                                   f"disagree: {err}, z {zerr}")
            times = {"port": [], "per_lane": []}
            for which in ("port", "per_lane", "per_lane", "port"):
                times[which].append(time_ms(port if which == "port"
                                            else lane))
            print(json.dumps({
                "F": feat, "H": heads,
                "dtype": str(dt).removeprefix("torch."), "V": v,
                "E": int(csr.col.numel()),
                "shared_u_ms": statistics.mean(times["port"]),
                "per_lane_u_ms": statistics.mean(times["per_lane"]),
                "runs_ms": times, "rel_err": err, "z_rel_err": zerr,
                "bit_identical": bool(torch.equal(h0, h1)
                                      and torch.equal(z0, z1))}),
                flush=True)
            del ht, ts, td, h0, h1, z0, z1
    print(json.dumps({"ptxas_port": registers(port_log),
                      "ptxas_per_lane": registers(per_lane_log),
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
