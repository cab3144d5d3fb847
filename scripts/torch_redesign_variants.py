#!/usr/bin/env python3
"""K1's dw kernel and the tile SpMM probe (P-T) against the design choices
they did not take.

    python3 scripts/torch_redesign_variants.py

Each variant below is the port's source with a few lines replaced
(`PATCHES`; every replaced text must occur exactly once, so a change to the
kernels stops the script instead of timing something else), built with the
port's nvcc flags into its own library under
`build/redesign_variants/` and loaded in place of the port's library
under the port's own wrappers (`ops/cuda/build.py`'s table of loaded
libraries and the wrappers' entry caches are reset for each variant):

* dw (`csrc/gather_agg.cu`) at the two training shapes of
  `scripts/torch_redesign_pair.py` (a device-sampled GSSAMPLEALLGPU
  batch's blocks, f32): 4 slot rows in flight (kept), 8, 8 under a
  64-register cap, every slot's row (16 or 32), and a slot repeating its
  predecessor's source (the padding) loading nothing and taking its
  predecessor's sums;
* P-T (`csrc/probe_tile.cu`) at configuration 0 and bisect case c2: 4 slab
  rows in flight a half-warp under a 64-register cap (kept), 8 under the
  cap, 4 without it, and the kept kernel reading only slab rows 0-63 (16
  KiB) in place of the edges' own, which changes its result: a timing of
  what the slab's working set costs, not a kernel.

dw is held to its plain version (1e-5) and P-T to `tile_spmm_ordered`
(bit for bit) wherever the variant computes the function.  dw is timed by
CUDA events over 20 calls, P-T by CUDA-graph replays of 4 calls
(`utils.timing.cuda_graph_ms`), and P-T's two kernels apart by
`torch.profiler` device times; each variant in the list's order, then in
reverse, both kept.  Prints each record as a JSON line, then the card's
name and power limit.  Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch_redesign_pair as pair  # noqa: E402
from torch_variant_tools import build_variants, event_ms, rel_err  # noqa: E402
from sgnn_tpu_torch import resolve_device  # noqa: E402
from sgnn_tpu_torch.ops import aggregate as agg  # noqa: E402
from sgnn_tpu_torch.ops import probes as pr  # noqa: E402
from sgnn_tpu_torch.ops.cuda import build as cuda_build  # noqa: E402
from sgnn_tpu_torch.ops.cuda import gather_agg as k1  # noqa: E402
from sgnn_tpu_torch.ops.cuda import probes as probe_k  # noqa: E402
from sgnn_tpu_torch.utils.timing import cuda_graph_ms  # noqa: E402

OUT_DIR = ROOT / "build" / "redesign_variants"
DW_BATCH = "  constexpr int kBatch = 4;\n"
DW_BOUNDS = ("template <typename T, int L, int VEC, int P>\n"
             "__global__ void __launch_bounds__(kWarpsPerBlock * 32)\n"
             "gather_agg_dw_kernel(")
DW_SLOTS = "      float acc[P];\n"
# a slot whose source repeats its predecessor's (the padding) loads
# nothing and takes the predecessor's partial sums
DW_REPEAT_SKIP = (
    (DW_SLOTS, """      unsigned repeats = 0;
      int prev = -1;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const int src = __shfl_sync(kFullMask, my_src[k / L], k % L, L);
        if (k < n && src == prev) repeats |= 1u << k;
        prev = src;
      }
""" + DW_SLOTS),
    ("if (live && k < n) {", "if (live && k < n && !((repeats >> k) & 1u)) {"),
    ("if (kb + u < n) {", "if (kb + u < n && !((repeats >> (kb + u)) & 1u)) {"),
    ("      int base = 0;\n", """#pragma unroll
      for (int k = 1; k < P; ++k) {
        if ((repeats >> k) & 1u) acc[k] = acc[k - 1];
      }
      int base = 0;
"""))
PT_UNROLL = "constexpr int kTileUnroll = 4;"
PT_BOUNDS = ("__global__ void __launch_bounds__(kSumWarps * 32, 2)\n"
             "tile_bucket_sum_kernel(")
PT_SLAB_ROW = "slab + static_cast<int64_t>(it.x) * feat + c"
# {source: ((variant, replacements, computes the function), ...)}
PATCHES = {
    "gather_agg": (
        ("batch4 (kept)", (), True),
        ("batch8", ((DW_BATCH, "  constexpr int kBatch = 8;\n"),), True),
        ("batch8_cap64", ((DW_BATCH, "  constexpr int kBatch = 8;\n"),
                          (DW_BOUNDS, DW_BOUNDS.replace(
                              "kWarpsPerBlock * 32)",
                              "kWarpsPerBlock * 32, 4)"))), True),
        ("every_slot", ((DW_BATCH, "  constexpr int kBatch = P;\n"),),
         True),
        ("repeat_skip", DW_REPEAT_SKIP, True)),
    "probe_tile": (
        ("unroll4_cap64 (kept)", (), True),
        ("unroll8_cap64", ((PT_UNROLL, "constexpr int kTileUnroll = 8;"),),
         True),
        ("unroll4_nocap", ((PT_BOUNDS, PT_BOUNDS.replace(", 2)", ")")),),
         True),
        ("slab_rows_0_63 (timing only)",
         ((PT_SLAB_ROW, PT_SLAB_ROW.replace("it.x", "(it.x & 63)")),),
         False)),
}


def use(source: str, lib: pathlib.Path) -> None:
    """Load `lib` in place of the port's `source` library."""
    cuda_build._built[source] = cuda_build.Built(
        name=source, path=lib, lib=ctypes.CDLL(str(lib)), seconds=0.0,
        log="")
    k1._entry.cache_clear()
    probe_k._entry.cache_clear()


def kernel_us(fn) -> dict:
    """Device microseconds a call of each kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            name = re.search(r"(\w+)\(", e.key.replace("(anonymous", ""))
            out[name.group(1) if name else e.key] = e.device_time_total / 5
    return out


def main() -> int:
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build_variants({source: [(name, reps) for name, reps, _ in vs]
                           for source, vs in PATCHES.items()}, OUT_DIR)
    dw_in = pair.dw_inputs(dev)
    tiles = [c for c in pair.tile_cases(dev) if c[0] in ("config 0", "c2")]
    records = {}
    for order in (1, -1):
        for name, _, exact in PATCHES["gather_agg"][::order]:
            use("gather_agg", libs["gather_agg", name])
            for layer, g, x, nbr, _ in dw_in:
                fn = k1.gather_agg_bwd_dw_cuda
                err = rel_err(fn(g, x, nbr),
                              agg.gather_agg_bwd_dw_plain(g, x, nbr))
                if exact and not err <= pair.TOL:
                    raise RuntimeError(f"dw {name} layer {layer}: {err}")
                rec = records.setdefault(("dw", name, layer), {
                    "kernel": "dw", "variant": name, "layer": layer,
                    "F": x.shape[1], "K": nbr.shape[1], "rel_err": err,
                    "layout": k1.dw_layout(g, x, nbr.shape[1]), "ms": []})
                rec["ms"].append(event_ms(lambda: fn(g, x, nbr),
                                          pair.DW_REPS))
        for name, _, exact in PATCHES["probe_tile"][::order]:
            use("probe_tile", libs["probe_tile", name])
            for case, fname, args in tiles:
                fn = getattr(pr, fname)
                got = fn(*args)
                if exact and not torch.equal(got,
                                             pr.tile_spmm_ordered(*args)):
                    raise RuntimeError(f"P-T {name} {case} differs from "
                                       f"its ordered sum")
                rec = records.setdefault(("pt", name, case), {
                    "kernel": "tile_spmm", "variant": name, "case": case,
                    "computes_the_function": exact,
                    "resources": probe_k.tile_sum_resources(),
                    "ms": [], "kernel_us": []})
                rec["ms"].append(cuda_graph_ms(lambda: fn(*args),
                                               pair.TILE_REPS))
                rec["kernel_us"].append(kernel_us(lambda: fn(*args)))
    for rec in records.values():
        print(json.dumps(rec), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
