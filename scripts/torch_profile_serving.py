#!/usr/bin/env python3
"""Where the port's serving time goes, on one NVIDIA card.

    python3 scripts/torch_profile_serving.py [--scale 1.0] [--out DIR]

Builds the serving configuration of chip_smoke.py (GCN 602-128-41, seed-0
weights, `reddit_like_dataset(seed=0, scale)`), warms the server, then
traces with `torch.profiler` one f32 `logprobs()` pass, one bf16 pass and
one query each of 8, 64 and 512 vertices.  For each it prints one JSON
line: the host wall time (ending in a synchronize), the device time summed
over the kernels the trace saw, the device's idle share (1 - device/wall)
and the five kernels with the most device time.  It also prints the peak
device memory with the f32 and the bf16 server resident, and the card's
name and power limit.  The full per-kernel tables go to
DIR/torch_profile_serving.txt (default build/profiles/).  Needs a CUDA
device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.graph.adjacency import Adjacency  # noqa: E402
from sgnn_tpu_torch.models.gnn import init_model  # noqa: E402
from sgnn_tpu_torch.train.inference import InferenceServer  # noqa: E402


def traced(label, fn, table_file):
    """Run fn once under the profiler; one JSON line of where time went."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    table_file.write(f"== {label}: wall {wall_ms:.3f} ms\n")
    table_file.write(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=25) + "\n")
    line = {"what": label, "wall_ms": wall_ms,
            "device_ms": dev_ms if events else None,
            "device_idle_share": (1.0 - dev_ms / wall_ms) if events else None,
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3,
                                e.count] for e in top]}
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_serving: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    ds = reddit_like_dataset(seed=0, scale=args.scale)
    adj = Adjacency.from_edges(ds.edges, ds.num_vertices)
    params = init_model(0, "gcn", [602, 128, 41], device=dev)
    torch.cuda.reset_peak_memory_stats()
    srv = InferenceServer(params, "gcn", adj, ds.features, device=dev)
    bsrv = InferenceServer(params, "gcn", adj, ds.features,
                           dtype=torch.bfloat16, device=dev)
    for s in (srv, bsrv):
        s.logprobs(as_numpy=False)
        s.logprobs(as_numpy=False)
    srv.warmup(sizes=(8, 64, 512))
    rng = np.random.default_rng(1)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "torch_profile_serving.txt", "w") as f:
        traced("f32 logprobs pass", lambda: srv.logprobs(as_numpy=False), f)
        traced("bf16 logprobs pass", lambda: bsrv.logprobs(as_numpy=False),
               f)
        for size in (8, 64, 512):
            nids = rng.choice(adj.num_vertices, size=size, replace=False)
            traced(f"query {size}", lambda: srv.query(nids), f)
    print(json.dumps({"graph": {"V": adj.num_vertices, "E": adj.num_edges},
                      "peak_device_mem_gb_f32_and_bf16_servers":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
