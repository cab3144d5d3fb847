#!/usr/bin/env python3
"""The readings each limit of `correct` is set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3,...
                                   [--out FILE]

For each seed, in one process (the graph is built once): the cell's
trainer is built and driven through its first three steps as a run drives
it (benchmark/program.py), its state is freed, and the numbers `correct`
compares are read four ways against the float64 reference:

  program         the program's own steps: the lower reading
  control         the reference in TF32 in the program's place (the
                  precision below the configuration's float32)
  half_batch      the reference with its loss averaged over half the
                  batch in the program's place (a planted fault)
  state_unchanged the reference whose steps return their state unchanged
                  in the program's place (a planted fault)
  dropout_all     dropout_z of a mask that keeps every activation, worked
                  out from the run's count (a planted fault; no run)

One JSON line a seed and reading; the last line gives, per number, the
largest program reading and the smallest control and fault readings.
Needs a card, as a run does; the benchmark's runs never run this.

    python3 benchmark/calibrate.py --summarize FILE... [--workload <cell>]

reads such lines (and result lines of benchmark/run.py, whose `checks`
are sound program readings too) and proposes each number's limit by the
rule `limit_for` states.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

READINGS = ("program", "control", "half_batch", "state_unchanged")


def diagnose(cell, inp, cap) -> dict:
    """Where a program reading comes from: each step's loss gap, each
    leaf's gap of first-gradient and change norms (the first gradient's
    also for the control, and the norms of both sides' differences from
    the reference's), and how many elements of each leaf's first gradient
    differ in sign from the reference's (Adam's first update is lr times
    that sign, so a flipped sign moves an element by two learning
    rates)."""
    import torch

    from benchmark import correctness

    cfg, p0 = cell.config, cap.p0
    ref = inp.ref.train_steps(cfg, bool(cell.workload["adam_bias_correction"]),
                              p0, correctness.step_inputs(inp, cell, cap))
    prog = correctness.program_steps(cfg, cap)
    control = inp.ref.train_steps(
        cfg, bool(cell.workload["adam_bias_correction"]), p0,
        correctness.step_inputs(inp, cell, cap), "tf32")
    out = {"loss_gaps": [abs(a - b) / abs(b) for a, b in
                         zip(prog["losses"], ref["losses"])]}
    leaves = []
    for i, (gp, gr, gc, pp, pr, q) in enumerate(zip(
            prog["grad1"], ref["grad1"], control["grad1"], prog["params"],
            ref["params"], cap.p0)):
        gr, gc = gr.double(), gc.double()
        dp, dr = pp.double() - q.double(), pr.double() - q.double()
        # elements whose first gradient is under a thousandth of the
        # leaf's median element's: Adam moves them by round-off alone
        small = gr.abs() < 1e-3 * gr.abs().median()
        leaves.append({
            "leaf": i, "numel": gr.numel(),
            "grad_norm": float(gr.norm()),
            "grad_gap": abs(float(gp.norm()) - float(gr.norm())),
            "grad_diff": float((gp.double() - gr).norm()),
            "control_grad_gap": abs(float(gc.norm()) - float(gr.norm())),
            "control_grad_diff": float((gc - gr).norm()),
            "sign_flips": int((torch.sign(gp.double())
                               != torch.sign(gr)).sum()),
            "min_abs_grad": float(gr.abs().min()),
            "dparam_norm": float(dr.norm()),
            "dparam_gap": abs(float(dp.norm()) - float(dr.norm())),
            "elements_small_grad": int(small.sum()),
            "dparam_gap_big_grad": abs(float(dp[~small].norm())
                                       - float(dr[~small].norm())),
            "dparam_max_elem_diff": float((dp - dr).abs().max())})
    out["leaves"] = leaves
    return out


def readings_for_seed(cell, arrays, seed: int, device, ref_mod,
                      with_diagnosis: bool = False) -> dict:
    import torch

    from benchmark import correctness, program

    dataset = program.make_dataset(arrays, cell.config["name"])
    trainer = program.build(cell, seed, dataset, device)
    program.set_weights(trainer, program.make_weights(cell, seed, device))
    cap = program.CAPTURES[cell.mode](cell, trainer)
    del trainer, dataset
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    inp = correctness.Inputs(arrays, device, ref_mod)
    out = {"program": correctness.judge(cell, inp, cap),
           "control": correctness.judge(cell, inp, cap,
                                        as_program="control"),
           "half_batch": correctness.judge(cell, inp, cap,
                                           as_program="half_batch")}
    out["state_unchanged"] = correctness.judge(cell, inp, cap,
                                               as_program="state_unchanged")
    if cap.drop_total:
        p = float(cell.config["drop_rate"])
        out["program"]["dropout_all_z"] = (
            p / math.sqrt(p * (1.0 - p) / cap.drop_total))
    if with_diagnosis:
        out["diagnosis"] = diagnose(cell, inp, cap)
    return out


def limit_for(lower: float, control: float, faults: dict) -> dict:
    """A number's limit from its readings.  The lower reading is the
    largest of the program's; the upper the smallest of: the control's
    where it is three times the lower or more, a fault's where it is ten
    times (a state left unchanged: three times).  The limit lies between,
    with more room above the lower: lower^(1/3) * upper^(2/3).  With no
    upper reading there is no limit (None)."""
    uppers = []
    if control is not None and control >= 3 * lower:
        uppers.append(control)
    for name, value in faults.items():
        factor = 3 if name == "state_unchanged" else 10
        if value is not None and value >= factor * lower:
            uppers.append(value)
    if not uppers:
        return {"lower": lower, "upper": None, "limit": None}
    upper = min(uppers)
    if lower <= 0:
        return {"lower": lower, "upper": upper, "limit": 0.0}
    return {"lower": lower, "upper": upper,
            "limit": float(f"{lower ** (1 / 3) * upper ** (2 / 3):.2g}")}


def summarize(paths, workload=None) -> dict:
    """Per cell and number: the readings' extremes and the proposed
    limit."""
    from benchmark import correctness

    prog, other = {}, {}
    for path in paths:
        for line in open(path):
            line = line.strip()
            if not line.startswith("{"):
                continue
            d = json.loads(line)
            if "reading" in d:
                w, kind = d["workload"], d["reading"]
                for k, v in d.items():
                    if k in correctness.NUMBERS:
                        (prog if kind == "program" else other).setdefault(
                            (w, k), {}).setdefault(kind, []).append(v)
                if "dropout_all_z" in d:
                    other.setdefault((w, "dropout_z"), {}).setdefault(
                        "dropout_all", []).append(d["dropout_all_z"])
            elif "checks" in d and workload:
                for k, c in d["checks"].items():
                    prog.setdefault((workload, k), {}).setdefault(
                        "program", []).append(c["value"])
    out = {}
    for (w, k), kinds in prog.items():
        if workload and w != workload:
            continue
        vals = kinds["program"]
        o = other.get((w, k), {})
        mins = {kind: min(v) for kind, v in o.items()}
        out.setdefault(w, {})[k] = {
            "n": len(vals), **limit_for(
                max(vals), mins.get("control"),
                {kind: v for kind, v in mins.items() if kind != "control"})}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default=None)
    ap.add_argument("--seeds", default=None, help="comma-separated seeds")
    ap.add_argument("--summarize", nargs="+", default=None,
                    help="calibration and result files to read")
    ap.add_argument("--out", default=None)
    ap.add_argument("--diagnose", action="store_true",
                    help="also print where each program reading comes from")
    args = ap.parse_args(argv)
    if args.summarize:
        print(json.dumps(summarize(args.summarize, args.workload), indent=1))
        return 0
    if not (args.workload and args.seeds):
        ap.error("--workload and --seeds are needed to take readings")
    import torch

    from benchmark import graph, spec

    if not torch.cuda.is_available():
        print("calibrate.py: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    arrays = graph.load_graph(cell.config["graph"])
    ref_mod = cell.reference
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings_for_seed(cell, arrays, seed, "cuda:0", ref_mod,
                              args.diagnose)
        if args.diagnose:
            print(json.dumps({"seed": seed, "diagnosis": r["diagnosis"]}),
                  flush=True)
        for kind in READINGS:
            line = {"workload": args.workload, "seed": seed, "reading": kind,
                    **r[kind]}
            lines.append(line)
            print(json.dumps(line), flush=True)
        print(json.dumps({"seed": seed,
                          "seconds": time.perf_counter() - t0}), flush=True)
    summary = {"workload": args.workload,
               "card": torch.cuda.get_device_name(0)}
    if "dropout_all_z" in lines[0]:
        summary["dropout_all_z_min"] = min(
            l["dropout_all_z"] for l in lines if "dropout_all_z" in l)
    for name in lines[0]:
        if name in ("workload", "seed", "reading", "dropout_all_z"):
            continue
        summary[name] = {
            "program_max": max(l[name] for l in lines
                               if l["reading"] == "program"),
            **{f"{k}_min": min(l[name] for l in lines if l["reading"] == k)
               for k in READINGS[1:]}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
            f.write(json.dumps(summary) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
