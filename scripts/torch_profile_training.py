#!/usr/bin/env python3
"""Where the port's sampled-training time goes, on one NVIDIA card.

    python3 scripts/torch_profile_training.py [--scale 1.0] [--out DIR]
        [--engine GSSAMPLEALLGPU|GATSAMPLEALLGPU|GCNFULLBATCH|GATFULLBATCH]
        [--heads N]

Builds the training configuration of chip_smoke.py (602-128-41, lr 0.01,
drop 0.5, `reddit_like_dataset(seed=0, scale)`).  Sampled engines (fanout
25-10, batch 10000): a device-sampled trainer (GSSAMPLEALLGPU, or
GATSAMPLEALLGPU with N heads) and a GCNSAMPLEGPU trainer (host sampler);
after one untraced warm-up epoch of the device trainer it runs, untraced
and then traced with `torch.profiler`, one device-sampled step, one whole
device-sampled epoch and one host-sampled step (sample, upload, train).
Whole-graph engines (GCNFULLBATCH, or GATFULLBATCH with N heads): after
one untraced warm-up epoch, one whole-graph epoch (forward, backward,
update and the METRICS:clean forward), untraced and then traced.  For
each it prints one JSON line: the host wall times (ending in a
synchronize), the device time summed over the kernels the trace saw, the
device's idle share (1 - device/wall, against the traced and the untraced
wall), the port's kernels' device time and share (K1's forward, dx's
transpose and CSR sum; or K2 forward and backward, K3, K4's B1 and B2),
and the eight kernels with the most device
time.  It also prints the peak device memory and the card's name and
power limit.  The full per-kernel tables go to
DIR/torch_profile_training[_<engine>].txt (default build/profiles/).
Needs a CUDA device; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch.config import RunConfig  # noqa: E402
from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.train import build_trainer  # noqa: E402


# the port's kernels, by substrings of their names in the trace: K1's
# forward (and dw), dx's transpose (its radix passes and fill) and its CSR
# sum (csr_sum.cuh's walk with SumPolicy and its fix-up, in whole-graph
# training K2's backward); K2's forward (a warp per row on the
# Reddit-shaped CSR); K3; B1 (the walk with SrcPolicy and its fix-up); B2.
# The fix-up's first level (csr_carry_group_kernel) is shared by K2's
# backward and B1, which never run in one engine
SUM_WALK = ("SumPolicy", "RowStore", "csr_carry_group")
SAMPLED_KERNELS = {"k1_fwd": ("gather_agg",), "k1_dx_sum": SUM_WALK,
                   "k1_dx_transpose": ("block_transpose",)}
FULL_KERNELS = {"k2_fwd": ("spmm_csr_kernel",), "k2_bwd": SUM_WALK,
                "k3": ("gat_kernel<",),
                "k4_b1": ("SrcPolicy", "SrcStore", "csr_carry_group"),
                "k4_b2": ("gat_bwd_dst_",)}


def traced(label, fn, table_file, kernels, **extra):
    """Run fn once untimed-by-the-profiler, then once under it; one JSON
    line of where time went.  The profiler adds host cost to every launch,
    so the idle share is also given against the untraced wall time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in events) / 1e3
    kernel_ms = {k: sum(e.self_device_time_total for e in events
                        if any(p in e.key for p in pats)) / 1e3
                 for k, pats in kernels.items()}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    table_file.write(f"== {label}: wall {wall_ms:.3f} ms\n")
    table_file.write(prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=30) + "\n")
    line = {"what": label, "wall_ms": wall_ms,
            "device_ms": dev_ms if events else None,
            "device_idle_share": (1.0 - dev_ms / wall_ms) if events else None,
            "untraced_wall_ms": plain_wall_ms,
            "device_idle_share_untraced": ((1.0 - dev_ms / plain_wall_ms)
                                           if events else None),
            "kernel_ms": kernel_ms,
            "kernel_share_of_device": {k: (t / dev_ms if dev_ms else None)
                                       for k, t in kernel_ms.items()},
            "top_kernels_ms": [[e.key[:60], e.self_device_time_total / 1e3,
                                e.count] for e in top], **extra}
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "profiles"))
    ap.add_argument("--engine", default="GSSAMPLEALLGPU",
                    choices=("GSSAMPLEALLGPU", "GATSAMPLEALLGPU",
                             "GCNFULLBATCH", "GATFULLBATCH"))
    ap.add_argument("--heads", type=int, default=1)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_training: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    ds = reddit_like_dataset(seed=0, scale=args.scale)
    batch = 10000

    def cfg(algo):
        return RunConfig(algorithm=algo, layer_sizes=[602, 128, 41],
                         fanout=[25, 10], batch_size=batch, learn_rate=0.01,
                         drop_rate=0.5, epochs=1, seed=0, heads=args.heads,
                         vertices=ds.num_vertices)

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "" if args.engine == "GSSAMPLEALLGPU" else f"_{args.engine}"
    torch.cuda.reset_peak_memory_stats()
    table = out_dir / f"torch_profile_training{tag}.txt"
    if args.engine.endswith("FULLBATCH"):
        full = build_trainer(cfg(args.engine), ds).base
        full.train_epoch()   # warm-up: library start-up, allocator
        with open(table, "w") as f:
            traced(f"{args.engine} epoch", full.train_epoch, f, FULL_KERNELS,
                   heads=args.heads, edges=full.adj.num_edges,
                   csr_transpose_s=full.transpose_s)
    else:
        profile_sampled(build_trainer(cfg(args.engine), ds),
                        build_trainer(cfg("GCNSAMPLEGPU"), ds), batch, args,
                        table)
    print(json.dumps({"graph": {"V": ds.num_vertices,
                                "E": int(ds.edges.shape[0])},
                      "peak_device_mem_gb":
                          torch.cuda.max_memory_allocated() / 1e9,
                      "card": smi}), flush=True)
    return 0


def profile_sampled(dev_tr, host_tr, batch, args, table):
    """One device-sampled step and epoch and one host-sampled step."""
    dev_tr.train_epoch()   # warm-up: library start-up, allocator
    seeds, valid = next(dev_tr._seed_batches(dev_tr.train_nids, True))
    order = host_tr._epoch_order(host_tr.train_nids)
    host_tr.train_step(host_tr._upload(host_tr._make_batch(
        order[:batch]))[0])

    def device_step():
        dev_tr.train_step(dev_tr.sample(seeds, valid))

    def host_step():
        item = host_tr._make_batch(order[batch:2 * batch])
        host_tr.train_step(host_tr._upload(item)[0])

    with open(table, "w") as f:
        traced(f"{args.engine} step", device_step, f, SAMPLED_KERNELS,
               heads=args.heads)
        traced(f"{args.engine} epoch", dev_tr.train_epoch, f,
               SAMPLED_KERNELS, steps=-(-len(dev_tr.train_nids) // batch))
        traced("GCNSAMPLEGPU step (sample+upload+train)", host_step, f,
               SAMPLED_KERNELS)


if __name__ == "__main__":
    sys.exit(main())
