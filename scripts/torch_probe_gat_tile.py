#!/usr/bin/env python3
"""GAT tile on an NVIDIA card: the Hopper counterpart of
probe_gat_kernel_parts.py.

    python3 scripts/torch_probe_gat_tile.py

First the probe's own tile (`gat_tile_inputs(seed=0)`: S 256, W 128, E 256
of which 200 live, F 128, heads 4): `gat_tile` (`sgnn_tpu_torch.ops.probes`,
csrc/probe_tile.cu) on the card, held to the plain version on the CPU
(out relative max-abs 5e-3: a one-ulp difference in exp can flip bf16(u);
z 1e-5: f32 sums in another order); prints the errors and "PROBE OK".
Then GAT_TILES (4096) independent tiles drawn the same way, timed on the
device (REPS calls captured into a CUDA graph, `utils.timing.cuda_graph_ms`,
which also counts the replays' kernel runs in the launch counts): ms, µs
per tile and ns per live edge.

Needs a CUDA device (it raises without one); imports nothing of JAX.
`check_tile` and `time_tiles` return the records chip_smoke.py's
kernel_probes phase reads.
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
from sgnn_tpu_torch.ops.cuda.probes import COUNTED  # noqa: E402
from sgnn_tpu_torch.utils.timing import cuda_graph_ms  # noqa: E402

REPS = 8
OUT_TOL, Z_TOL = 5e-3, 1e-5


def tile_args(device, n_tiles: int = 1):
    t = pr.to_torch(pr.gat_tile_inputs(0, n_tiles), device)
    return t["slab"], t["ts"], t["td"], t["src"], t["dst"], pr.GAT_HEADS


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.cpu() - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def check_tile(device):
    """The probe's tile on `device` against the plain version on the CPU;
    raises above OUT_TOL / Z_TOL."""
    args = tile_args(device)
    out, z = pr.gat_tile(*args)
    ref_out, ref_z = pr.gat_tile_plain(
        *(a.cpu() if torch.is_tensor(a) else a for a in args))
    errs = {"out": rel_err(out, ref_out), "z": rel_err(z, ref_z)}
    if not (errs["out"] <= OUT_TOL and errs["z"] <= Z_TOL):
        raise RuntimeError(f"gat_tile: rel err {errs} above "
                           f"{OUT_TOL} / {Z_TOL}")
    return errs


def time_tiles(device):
    args = tile_args(device, pr.GAT_TILES)
    ms = cuda_graph_ms(lambda: pr.gat_tile(*args), REPS, COUNTED)
    live = int((args[4] < pr.GAT_W).sum())
    return {"tiles": pr.GAT_TILES, "live_edges": live, "ms": ms,
            "us_per_tile": ms * 1e3 / pr.GAT_TILES,
            "ns_per_live_edge": ms * 1e6 / live}


def main() -> int:
    dev = resolve_device(None)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    errs = check_tile(dev)
    print(f"backend=cuda rel_err out={errs['out']:.2e} z={errs['z']:.2e}",
          flush=True)
    print("PROBE OK", flush=True)
    r = time_tiles(dev)
    print(f"{r['tiles']} tiles: {r['ms']:.4f} ms ({r['us_per_tile']:.4f} "
          f"us/tile, {r['ns_per_live_edge']:.4f} ns/live edge)", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "nvidia_smi": smi, "check": errs, "timing": r}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
