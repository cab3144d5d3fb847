#!/usr/bin/env python3
"""Time K1's dw kernel, K1's dx transpose and the tile SpMM probe (P-T)
of this checkout beside another checkout's, in one process on one card.

    python3 scripts/torch_redesign_pair.py --parent DIR [--out FILE]

DIR is the root of another checkout of the repository (for example the
parent commit, unpacked with `git archive`); its `sgnn_tpu_torch` is loaded
under another module name and builds its kernels into DIR/build/.  Both
packages' wrappers keep the same names and signatures, so the same inputs
go through each in turn, in the order parent, change, change, parent:

- dw (`gather_agg_bwd_dw_cuda`) at the two full-width training shapes,
  the blocks of one device-sampled GSSAMPLEALLGPU batch (GraphSAGE
  602-128-41, fanout 25-10, batch 10000, `reddit_like_dataset(seed=0,
  scale=1.0)`, as chip_smoke.py's kernel_k1 phase draws them), f32:
  CUDA events over 20 calls, as chip_smoke.py times it;
- dx's transpose (`block_transpose_cuda`, its radix passes and fill) on
  the same two blocks, timed the same way;
- P-T (`tile_spmm` / `tile_gather`) at configuration 0 and the six bisect
  cases: CUDA-graph replays of 4 calls (`utils.timing.cuda_graph_ms`), as
  scripts/torch_probe_tile_spmm.py times them.

Each result is held to its plain version (1e-5 relative; the gather and
the transpose exactly) before it is timed, and each design's repeat to its first result
(`repeat_bit_identical`).  Prints the card's name and power limit and one
JSON object; `--out` also writes it to FILE.  Needs a CUDA device and
imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sgnn_tpu_torch import resolve_device  # noqa: E402
from sgnn_tpu_torch.config import RunConfig  # noqa: E402
from sgnn_tpu_torch.data.synthetic import reddit_like_dataset  # noqa: E402
from sgnn_tpu_torch.ops import aggregate as agg  # noqa: E402
from sgnn_tpu_torch.ops import probes as pr  # noqa: E402
from sgnn_tpu_torch.sampler.device import device_sample_batch  # noqa: E402
from sgnn_tpu_torch.train import build_trainer  # noqa: E402
from sgnn_tpu_torch.utils.timing import cuda_graph_ms  # noqa: E402
from torch_variant_tools import event_ms, rel_err  # noqa: E402

LAYERS, FANOUT, BATCH = [602, 128, 41], [25, 10], 10000
DW_REPS, TILE_REPS = 20, 4
TOL = 1e-5
ORDER = ("parent", "change", "change", "parent")


def load_parent(root: pathlib.Path):
    """The other checkout's package, as module `parent_port`."""
    pkg = root / "sgnn_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "parent_port", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = mod
    spec.loader.exec_module(mod)
    return mod


def dw_inputs(dev):
    """(layer, g, x, nbr, w) at the two training shapes."""
    ds = reddit_like_dataset(seed=0, scale=1.0)
    cfg = RunConfig(algorithm="GSSAMPLEALLGPU", layer_sizes=LAYERS,
                    fanout=FANOUT, batch_size=BATCH, learn_rate=0.01,
                    drop_rate=0.5, epochs=1, seed=0,
                    vertices=ds.num_vertices)
    tr = build_trainer(cfg, ds, device=dev)
    seeds = torch.zeros(tr.seed_pad, dtype=torch.int32)
    seeds[:BATCH] = torch.from_numpy(tr.train_nids[:BATCH].astype("int32"))
    sample = device_sample_batch(
        torch.Generator(device=dev).manual_seed(1), seeds.to(dev),
        (torch.arange(tr.seed_pad) < BATCH).to(dev), tr.dev_indptr,
        tr.dev_indices, tr.dev_in_deg, tr.dev_out_deg, tr.dev_features,
        tr.dev_labels, tuple(FANOUT), tr.src_pads, tr.weight_kind,
        degree_mode=tr.dev_degree_mode)
    gen = torch.Generator().manual_seed(0)
    out = []
    for layer, feat in ((0, LAYERS[1]), (1, LAYERS[2])):
        blk = sample.blocks[layer]
        d, _ = blk.nbr.shape
        x = torch.randn(blk.num_src_pad, feat, generator=gen).to(dev)
        g = torch.randn(d, feat, generator=gen).to(dev)
        out.append((layer, g, x, blk.nbr, blk.weight))
    return out


def tile_cases(dev):
    s_blk, d_blk, e_t, e_sub, w_win = pr.TILE_CONFIGS["0"]
    t = pr.to_torch(pr.tile_inputs(0, s_blk, d_blk, e_t, e_sub, w_win), dev)
    cases = [("config 0", "tile_spmm", (t["slab"], t["src"], t["dst"],
                                        t["w"], t["r0"], d_blk))]
    p = pr.to_torch(pr.tile_part_inputs(0), dev)
    for part in pr.TILE_PARTS:
        fn, args = pr.tile_part_args(part, p["slab"], p["src"], p["w"],
                                     p["r0s"])
        cases.append((part, fn.__name__, args))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args()
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    parent = load_parent(args.parent.resolve())
    designs = {
        "parent": (importlib.import_module("parent_port.ops.cuda.gather_agg"),
                   importlib.import_module("parent_port.ops.probes")),
        "change": (importlib.import_module(
            "sgnn_tpu_torch.ops.cuda.gather_agg"), pr)}
    del parent
    dw_rows, transpose_rows = [], []
    for layer, g, x, nbr, w in dw_inputs(dev):
        ref = agg.gather_agg_bwd_dw_plain(g, x, nbr)
        row = {"layer": layer, "D": nbr.shape[0], "K": nbr.shape[1],
               "S": x.shape[0], "F": x.shape[1], "ms": {}}
        for name in ORDER:
            fn = designs[name][0].gather_agg_bwd_dw_cuda
            got, again = fn(g, x, nbr), fn(g, x, nbr)
            err = rel_err(got, ref)
            if not err <= TOL:
                raise RuntimeError(f"dw {name} layer {layer}: rel err {err}")
            row.setdefault("rel_err", {})[name] = err
            row.setdefault("repeat_bit_identical", {})[name] = bool(
                torch.equal(got, again))
            row["ms"].setdefault(name, []).append(
                event_ms(lambda: fn(g, x, nbr), DW_REPS))
        row["layout"] = designs["change"][0].dw_layout(g, x, nbr.shape[1])
        dw_rows.append(row)
        del ref, got, again
        s_ = x.shape[0]
        ref = agg.block_transpose_plain(nbr, w, s_)
        row = {"layer": layer, "D": nbr.shape[0], "K": nbr.shape[1],
               "S": s_, "ms": {}}
        for name in ORDER:
            fn = designs[name][0].block_transpose_cuda
            if not all(torch.equal(a, b)
                       for a, b in zip(fn(nbr, w, s_), ref)):
                raise RuntimeError(f"transpose {name} layer {layer} "
                                   f"differs from plain")
            row["ms"].setdefault(name, []).append(
                event_ms(lambda: fn(nbr, w, s_), DW_REPS))
        transpose_rows.append(row)
        del ref
    tile_rows = []
    for case, fname, targs in tile_cases(dev):
        plain = (pr.tile_gather_plain if fname == "tile_gather"
                 else pr.tile_spmm_plain)
        ref = plain(*targs)
        row = {"case": case, "edges": targs[1].numel(), "ms": {}}
        for name in ORDER:
            fn = getattr(designs[name][1], fname)
            got, again = fn(*targs), fn(*targs)
            err = rel_err(got, ref)
            if not err <= TOL or (fname == "tile_gather"
                                  and not torch.equal(got, ref)):
                raise RuntimeError(f"tile {case} {name}: rel err {err}")
            row.setdefault("rel_err", {})[name] = err
            row.setdefault("repeat_bit_identical", {})[name] = bool(
                torch.equal(got, again))
            row["ms"].setdefault(name, []).append(
                cuda_graph_ms(lambda: fn(*targs), TILE_REPS))
        tile_rows.append(row)
    from sgnn_tpu_torch.ops.cuda.probes import tile_sum_resources
    result = {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi,
              "order": ORDER, "dw": dw_rows,
              "block_transpose": transpose_rows, "tile": tile_rows,
              "tile_sum_resources": tile_sum_resources()}
    print(smi, flush=True)
    text = json.dumps(result)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
