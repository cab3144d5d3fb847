#!/usr/bin/env python3
"""Row-gather and shuffle rates of an NVIDIA card: the Hopper counterpart of
profile_vmem_gather.py and probe_dyngather_shapes.py.

    python3 scripts/torch_probe_gather.py

P-G (`sgnn_tpu_torch.ops.probes.gather_sum`, csrc/probe_gather.cu):
out[i] = Σ of the 2048 table rows that tile i of the indices names, E = 2^20
indices from `gather_inputs(seed=0, T)`, F = 128, f32.  Timed four ways:
the table's column slices resident in shared memory and the table in device
memory at the probe's T = 2048 (1 MiB: it stays in L2); the table in device
memory at T = 232,965 (the Reddit-shaped vertex count, 119 MB, each row
drawn about 4.5 times: part of it stays in L2 between draws); and at T =
2^22 (2 GiB: almost every draw a row not in L2).  Prints ms and ns per
gathered row for each: the card's shared-memory and L2 random-row rates,
the rate at Reddit's table size with L2 warm, and the HBM rate.

P-S (`shuffle`): at each of the probe's nine shapes, REPS calls of 64 grid
steps each (every step's shuffle is done, the last one's result stands),
each call fed the last one's result as the probe's scan chains them;
prints µs per shuffle and ns per element.

Times are device times: REPS calls captured into a CUDA graph, its replay
between CUDA events (`utils.timing.cuda_graph_ms`, which also counts the
replays' kernel runs in the wrappers' launch counts).  Needs a CUDA device
(it raises without one); imports nothing of JAX.  `gather_cases`,
`time_gather` and `time_shuffle` are what chip_smoke.py's kernel_probes
phase drives.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch import resolve_device  # noqa: E402
from sgnn_tpu_torch.ops import probes as pr  # noqa: E402
from sgnn_tpu_torch.ops.cuda.probes import (  # noqa: E402
    COUNTED, RESIDENT_MAX_ROWS,
)
from sgnn_tpu_torch.utils.timing import cuda_graph_ms  # noqa: E402

# calls timed per case: the TPU probes chained K = 8 through one scan
# (profile_vmem_gather.py:40, probe_dyngather_shapes.py:15)
REPS = 8


def gather_cases(device):
    """(T, resident, table, idx) for the timed cases, on `device`."""
    for t_rows in pr.GATHER_ROWS:
        table, idx = (torch.from_numpy(a).to(device)
                      for a in pr.gather_inputs(0, t_rows))
        for resident in (True, False):
            if resident and t_rows > RESIDENT_MAX_ROWS:
                continue
            yield t_rows, resident, table, idx


def time_gather(cases):
    """One record per case of `gather_cases`: T, F, E, variant, ms, ns per
    row."""
    recs = []
    for t_rows, resident, table, idx in cases:
        ms = cuda_graph_ms(lambda: pr.gather_sum(table, idx, resident), REPS,
                           COUNTED)
        recs.append({"T": t_rows, "F": table.shape[1], "E": idx.numel(),
                     "variant": "shared" if resident else "global",
                     "ms": ms, "ns_per_row": ms * 1e6 / idx.numel()})
    return recs


def time_shuffle(device):
    """One record per probe shape: m, n, axis, ms per call of 64 steps,
    µs per shuffle, ns per element."""
    recs = []
    for (m, n), axis in pr.SHUFFLE_SHAPES:
        x = torch.from_numpy(pr.shuffle_input(0, m, n)).to(device)
        chain = [x]

        def step():
            chain[0] = pr.shuffle(chain[0], axis)

        ms = cuda_graph_ms(step, REPS, COUNTED)
        us = ms * 1e3 / pr.SHUFFLE_STEPS
        recs.append({"m": m, "n": n, "axis": axis, "ms": ms,
                     "us_per_shuffle": us, "ns_per_elem": us * 1e3 / (m * n)})
    return recs


def main() -> int:
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gathers = time_gather(gather_cases(dev))
    for r in gathers:
        print(f"T={r['T']} F={r['F']} E={r['E']}: {r['variant']:6s} "
              f"{r['ms']:8.4f} ms ({r['ns_per_row']:7.4f} ns/row)",
              flush=True)
    shuffles = time_shuffle(dev)
    for r in shuffles:
        print(f"  [{r['m']},{r['n']}] axis={r['axis']}: OK "
              f"{r['us_per_shuffle']:9.4f} us/shuffle "
              f"({r['ns_per_elem']:6.4f} ns/elem)", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": smi, "gather": gathers,
                      "shuffle": shuffles}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
