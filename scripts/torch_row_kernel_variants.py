#!/usr/bin/env python3
"""K2's forward row kernel and K4's B2 against the design choices they
did not take.

    python3 scripts/torch_row_kernel_variants.py

Both kernels are a warp per CSR row (`sgnn_tpu_torch/csrc/spmm.cu`
`spmm_csr_kernel`, `csrc/gat_bwd.cu` `gat_bwd_dst_kernel`).  Each variant
below is the port's source with a few lines replaced (`PATCHES`; every
replaced text must occur exactly once, so a change to the kernels stops
the script instead of timing something else), built with the port's nvcc
flags into its own library under `build/row_kernel_variants/` and called
through the port's own C entry (`sgnn_spmm_csr`, `sgnn_gat_bwd_dst`):

* K2 forward at F = 128 and 41, f32 and bf16 (one GCN serving pass's two
  SpMMs) on the Reddit-shaped graph's CSR (`reddit_like_dataset(seed=0,
  scale=1.0)`, keyed by destination, GCN weights): each window's (col, w)
  staged in shared memory (kept) or broadcast by shuffles, each with and
  without the 48-register cap (`__launch_bounds__(256, 5)`);
* B2 at (F, H) = (128, 4), (128, 1) and (41, 1), f32 (one GATFULLBATCH
  epoch's two layers, and the single-head F = 128 layer), on the same CSR:
  one reduction of the head's dot product per four edges (the identity,
  kept) or one per edge, the sources staged in shared memory (kept) or
  broadcast by shuffles, and a register cap by layout (kept: 64 with
  vector columns, 48 with scalar ones), of 48 or 64 everywhere, or none.

Each variant is held to the plain version (relative max-abs 1e-5 f32,
5e-3 bf16) and to itself on repeat (bit-identical), then timed with CUDA
events over 20 launches after a warm-up launch, L2 not flushed, in the
order of the list and then in reverse; the two are averaged.  One JSON
line per shape, with each variant's registers and local (spill) bytes a
thread as its loaded library reports them, then the card's name and
power limit.  The parent commit's `chip_smoke.py` times the first row
kernels.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys
import threading

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.graph.adjacency import Adjacency  # noqa: E402
from sgnn_tpu_torch.ops.gat import (  # noqa: E402
    gat_bwd_dst_plain, pack_score_tables,
)
from sgnn_tpu_torch.ops.segment import (  # noqa: E402
    DTYPE_CODES, csr_from_numpy, spmm_csr_plain,
)
from sgnn_tpu_torch.sampler.blocks import WeightKind  # noqa: E402
from sgnn_tpu_torch.train.fullbatch import build_coo  # noqa: E402
from torch_variant_tools import (  # noqa: E402
    build_variants, event_ms, rel_err,
)

REPS = 20
TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
K2_SHAPES = ((128, torch.float32), (41, torch.float32),
             (128, torch.bfloat16), (41, torch.bfloat16))
B2_SHAPES = ((128, 4), (128, 1), (41, 1))
OUT_DIR = ROOT / "build" / "row_kernel_variants"

# K2: (col, w) broadcast by shuffles instead of staged
K2_SHUFFLE = (
    ("        my_stage[lane] = make_int2(my_col, __float_as_int(my_w));\n"
     "        __syncwarp();\n", ""),
    ("const int2 s = my_stage[e & 31];",
     "const int2 s = make_int2(__shfl_sync(kFullMask, my_col, e & 31),"
     " __float_as_int(__shfl_sync(kFullMask, my_w, e & 31)));"))
K2_NOCAP = (("__launch_bounds__(kWarpsPerBlock * 32, 5)",
             "__launch_bounds__(kWarpsPerBlock * 32)"),)
# B2: sources broadcast by shuffles instead of staged
B2_SHUFFLE = (("        ss[lane] = my_src;\n", ""),
              ("ss[(k + u) & 31]",
               "__shfl_sync(kFullMask, my_src, (k + u) & 31)"))


def b2_cap(min_blocks: str):
    return (("VEC == 4 ? 4 : 5", min_blocks),)


# B2: t = <Gz[d], ht[s]>_h reduced and q = c * (t - rz) added an edge, in
# place of the identity's sums and their flush a kUnroll edges
B2_PER_EDGE_START = ("#pragma unroll\n          for (int u = 0; u < kUnroll; "
                     "++u) {\n            if (k + u >= n) break;\n")
B2_PER_EDGE_END = "for (int j = 0; j < COLS; ++j) csum[j] = 0.0f;\n"
B2_PER_EDGE_BODY = B2_PER_EDGE_START + r"""            float p[COLS];
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
              p[j] = 0.0f;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                p[j] = fmaf(x[u][j][v], g[j][v], p[j]);
              }
            }
            if (one) {
              float pp = p[0];
#pragma unroll
              for (int j = 1; j < COLS; ++j) pp += p[j];
              q[0] = fmaf(cs[slot[0] + k + u], group_sum(pp, group) - r[0],
                          q[0]);
            } else {
#pragma unroll
              for (int j = 0; j < COLS; ++j) {
                q[j] = fmaf(cs[slot[j] + k + u],
                            group_sum(p[j], group) - r[j], q[j]);
              }
            }
          }
"""
B2_PER_EDGE = (((B2_PER_EDGE_START, B2_PER_EDGE_END), B2_PER_EDGE_BODY),)

# {source: ((variant, replacements), ...)}; "kept" is the port's source
PATCHES = {
    "spmm": (("staged_cap48 (kept)", ()),
             ("shuffle_cap48", K2_SHUFFLE),
             ("staged_nocap", K2_NOCAP),
             ("shuffle_nocap", K2_SHUFFLE + K2_NOCAP)),
    "gat_bwd": (("identity_staged_cap64v48s (kept)", ()),
                ("identity_staged_cap48", b2_cap("5")),
                ("identity_staged_cap64", b2_cap("4")),
                ("identity_staged_nocap", b2_cap("1")),
                ("identity_shuffle_cap64v48s", B2_SHUFFLE),
                ("per_edge_staged_cap64v48s", B2_PER_EDGE),
                ("per_edge_staged_cap48", B2_PER_EDGE + b2_cap("5")),
                ("per_edge_staged_cap64", B2_PER_EDGE + b2_cap("4"))),
}


def timed(cases):
    """{name: mean ms} over the list in order and then reversed."""
    runs = {name: [] for name, _ in cases}
    for name, fn in list(cases) + list(reversed(cases)):
        runs[name].append(event_ms(fn, REPS))
    return {name: statistics.mean(r) for name, r in runs.items()}, runs


def held(kernel, shape, variants, run, ref, tol):
    """Each variant's error against `ref` and its repeat, checked; and its
    time."""
    errs, same = {}, {}
    for name in variants:
        got = run(name)
        errs[name] = rel_err(got, ref)
        same[name] = bool(torch.equal(got, run(name)))
        if errs[name] > tol or not same[name]:
            raise RuntimeError(f"{kernel} {name} {shape}: error {errs[name]}"
                               f", bit-identical on repeat {same[name]}")
    ms, runs = timed([(name, lambda name=name: run(name))
                      for name in variants])
    return {"ms": ms, "runs_ms": runs, "rel_err": errs,
            "bit_identical_on_repeat": same}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_row_kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    built = {}
    compiling = threading.Thread(
        target=lambda: built.update(
            (key, ctypes.CDLL(str(lib))) for key, lib in
            build_variants(PATCHES, OUT_DIR).items()))
    compiling.start()
    ds = reddit_like_dataset(seed=0, scale=1.0)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    v = adj.num_vertices
    src, _, w = build_coo(adj, WeightKind.GCN)
    csr = csr_from_numpy(adj.indptr, src, w, v, dev)
    compiling.join()
    if len(built) != sum(len(x) for x in PATCHES.values()):
        raise RuntimeError("the variant build failed")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    out_int = [ctypes.POINTER(i32)] * 5
    k2, k2_lay, b2, b2_lay = {}, {}, {}, {}
    for (source, name), lib in built.items():
        if source == "spmm":
            k2[name], k2_lay[name] = lib.sgnn_spmm_csr, lib.sgnn_spmm_csr_layout
            k2[name].argtypes = [ptr] * 5 + [i64, i64, i32, ptr]
            k2_lay[name].argtypes = [ptr, i64, i32] + out_int
        else:
            b2[name], b2_lay[name] = (lib.sgnn_gat_bwd_dst,
                                      lib.sgnn_gat_bwd_dst_layout)
            b2[name].argtypes = [ptr] * 8 + [i64, i64, i32, i32, ptr]
            b2_lay[name].argtypes = [ptr, ptr, i64, i32, i32] + out_int
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator().manual_seed(8)

    def resources(fn, *args):
        got = [ctypes.c_int() for _ in range(5)]
        if fn(*args, *(ctypes.byref(g) for g in got)) != 0:
            raise RuntimeError("the layout query failed")
        return {"registers": got[3].value, "local_bytes": got[4].value}

    for feat, dt in K2_SHAPES:
        x = torch.randn(v, feat, generator=gen).to(dev, dt)

        def run_k2(name):
            out = torch.empty_like(x)
            rc = k2[name](x.data_ptr(), csr.rowptr.data_ptr(),
                          csr.col.data_ptr(), csr.w.data_ptr(),
                          out.data_ptr(), v, feat, DTYPE_CODES[dt], stream)
            if rc != 0:
                raise RuntimeError(f"K2 variant {name}: CUDA error {rc}")
            return out

        res = held("spmm_csr", (feat, dt), k2, run_k2,
                   spmm_csr_plain(x.float(), *csr), TOL[dt])
        res["resources"] = {n: resources(f, x.data_ptr(), feat,
                                         DTYPE_CODES[dt])
                            for n, f in k2_lay.items()}
        print(json.dumps({"kernel": "spmm_csr", "F": feat,
                          "dtype": str(dt).removeprefix("torch."), "V": v,
                          "E": int(csr.col.numel()), **res}), flush=True)
        del x

    for feat, heads in B2_SHAPES:
        ht = torch.randn(v, feat, generator=gen).to(dev)
        a = (torch.randn(2, feat, generator=gen)
             * (2.0 / (feat // heads) ** 0.5)).to(dev)
        ts, td = pack_score_tables(ht, a[0], a[1], heads)
        gz = torch.randn(v, feat, generator=gen).to(dev)
        rz = torch.randn(v, heads, generator=gen).to(dev)

        def run_b2(name):
            out = torch.empty((v, heads), dtype=torch.float32, device=dev)
            rc = b2[name](ht.data_ptr(), ts.data_ptr(), gz.data_ptr(),
                          td.data_ptr(), rz.data_ptr(), csr.rowptr.data_ptr(),
                          csr.col.data_ptr(), out.data_ptr(), v, feat, heads,
                          DTYPE_CODES[torch.float32], stream)
            if rc != 0:
                raise RuntimeError(f"B2 variant {name}: CUDA error {rc}")
            return out

        res = held("gat_bwd_dst", (feat, heads), b2, run_b2,
                   gat_bwd_dst_plain(ht, ts, gz, td, rz, csr.rowptr, csr.col,
                                     heads), TOL[torch.float32])
        res["resources"] = {n: resources(f, ht.data_ptr(), gz.data_ptr(),
                                         feat, heads,
                                         DTYPE_CODES[torch.float32])
                            for n, f in b2_lay.items()}
        print(json.dumps({"kernel": "gat_bwd_dst", "F": feat, "H": heads,
                          "dtype": "float32", "V": v,
                          "E": int(csr.col.numel()), **res}), flush=True)
        del ht, ts, td, gz, rz
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
