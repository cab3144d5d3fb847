#!/usr/bin/env python3
"""Tile SpMM rate of an NVIDIA card: the Hopper counterpart of
profile_onehot_spmm.py and the bisect cases of probe_onehot_parts.py and
probe_onehot_parts2.py.

    python3 scripts/torch_probe_tile_spmm.py [KEY ...]

For each configuration KEY (0-13, profile_onehot_spmm.py's `cfgs`; default
0): `tile_spmm` (`sgnn_tpu_torch.ops.probes`, csrc/probe_tile.cu) over 512
steps of E_T edges from `tile_inputs(seed=0, ...)`, all summed into one
[8192, 128] f32 block, the way the TPU probe ran `onehot_spmm`.  Prints ms,
ns per edge and TFLOP/s in the probe's format; the TFLOP/s counts the
one-hot formulation's 2F(S_BLK + W) operations an edge, as the probe did,
so that the two read alike (the kernel itself does 2F).  Configuration 0
is first held to the plain version on the CPU over 4 steps.

Then each bisect case (`tile_part_args`: c1, c2, c3, a, b, c) at the parts
scripts' sizes (S_BLK 1024, E_T 2048, W 1280, D_BLK 8192, 4 steps): ms and
ns per edge.

Times are device times: REPS calls captured into a CUDA graph, its replay
between CUDA events (`utils.timing.cuda_graph_ms`, which also counts the
replays' kernel runs in the wrappers' launch counts).  Needs a CUDA device
(it raises without one); imports nothing of JAX.  `time_config` and
`time_parts` return the records chip_smoke.py's kernel_probes phase reads.
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

from sgnn_tpu_torch import resolve_device  # noqa: E402
from sgnn_tpu_torch.ops import probes as pr  # noqa: E402
from sgnn_tpu_torch.ops.cuda.probes import COUNTED  # noqa: E402
from sgnn_tpu_torch.utils.timing import cuda_graph_ms  # noqa: E402

# calls timed per case (profile_onehot_spmm.py:40's K_ITERS)
REPS = 4
# the correctness check's steps (profile_onehot_spmm.py:146) and bound:
# products are exact and only the f32 order of the sums differs
CHECK_STEPS, CHECK_TOL = 4, 1e-5
# the whole-graph pass the probe scaled its rate to (:174)
PASS_EDGES = 11.9e6


def config_inputs(key: str, device, n_steps: int = pr.TILE_STEPS):
    s_blk, d_blk, e_t, e_sub, w_win = pr.TILE_CONFIGS[key]
    t = pr.to_torch(pr.tile_inputs(0, s_blk, d_blk, e_t, e_sub, w_win,
                                   n_steps), device)
    return (t["slab"], t["src"], t["dst"], t["w"], t["r0"], d_blk)


def check_config(key: str, device) -> float:
    """Relative max-abs error of the card's first CHECK_STEPS steps against
    the plain version on the CPU; raises above CHECK_TOL."""
    args = config_inputs(key, device, CHECK_STEPS)
    got = pr.tile_spmm(*args).cpu()
    ref = pr.tile_spmm_plain(*(a.cpu() if torch.is_tensor(a) else a
                               for a in args))
    err = ((got - ref).abs().max() / ref.abs().max()).item()
    if not err <= CHECK_TOL:
        raise RuntimeError(f"tile_spmm config {key}: rel err {err} > "
                           f"{CHECK_TOL}")
    return err


def time_config(key: str, device):
    s_blk, d_blk, e_t, e_sub, w_win = pr.TILE_CONFIGS[key]
    args = config_inputs(key, device)
    ms = cuda_graph_ms(lambda: pr.tile_spmm(*args), REPS, COUNTED)
    edges = args[1].numel()
    onehot_flop = 2 * pr.PROBE_F * (s_blk + w_win) * edges
    return {"key": key, "S_BLK": s_blk, "D_BLK": d_blk, "E_T": e_t,
            "E_sub": e_sub, "W": w_win, "edges": edges, "ms": ms,
            "ns_per_edge": ms * 1e6 / edges,
            "onehot_tflops_eff": onehot_flop / (ms * 1e-3) / 1e12,
            "pass_ms_11_9M": ms / edges * PASS_EDGES}


def part_inputs(device):
    t = pr.to_torch(pr.tile_part_inputs(0), device)
    return t["slab"], t["src"], t["w"], t["r0s"]


def time_parts(device):
    slab, src, w, r0s = part_inputs(device)
    recs = []
    for part in pr.TILE_PARTS:
        fn, args = pr.tile_part_args(part, slab, src, w, r0s)
        ms = cuda_graph_ms(lambda: fn(*args), REPS, COUNTED)
        recs.append({"part": part, "edges": src.numel(), "ms": ms,
                     "ns_per_edge": ms * 1e6 / src.numel()})
    return recs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("keys", nargs="*",
                    choices=sorted(pr.TILE_CONFIGS, key=int))
    args = ap.parse_args()
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    configs = []
    for key in args.keys or ["0"]:
        if key == "0":
            err = check_config(key, dev)
            print(f"correctness ({CHECK_STEPS} steps): max rel err "
                  f"{err:.2e}", flush=True)
        r = time_config(key, dev)
        configs.append(r)
        print(f"S={r['S_BLK']} W={r['W']} E_sub={r['E_sub']} "
              f"E_T={r['E_T']}: {r['ms']:.4f} ms / {r['edges']} edges = "
              f"{r['ns_per_edge']:.4f} ns/edge  ({r['onehot_tflops_eff']:.1f}"
              f" TFLOP/s eff; 11.9M-edge pass ~{r['pass_ms_11_9M']:.2f} ms)",
              flush=True)
    parts = time_parts(dev)
    for r in parts:
        print(f"  {r['part']:2s}: {r['ms']:.4f} ms / {r['edges']} edges = "
              f"{r['ns_per_edge']:.4f} ns/edge", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": smi, "configs": configs,
                      "parts": parts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
