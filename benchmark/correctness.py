"""How `correct` is decided: the program's first three training steps
against the plain reference (benchmark/reference/), from the same inputs
and the same initial parameters.

Numbers read; a cell compares those its `limits/<cell>.json` names, each
against its own limit:

  loss_gap     the largest of the three steps' |program loss - reference
               loss| / |reference loss|
  loss1_gap    the same for the first step alone
  grad1_gap    the first gradient as the optimizer got it (worked out from
               its first moment after one step, weight decay included):
               the largest over leaves of |program norm - reference norm|
               over the larger of that leaf's and the median leaf's
               reference norm
  grad1_median_diff  the first gradient's difference from the
               reference's, the median leaf's norm of it over the larger
               of that leaf's and the median leaf's reference norm: a
               leaf's norm averages random rounding away, its difference
               does not, and the median leaf is not moved by one leaf's
               rare large difference (PERF.md)
  dparam_gap   the parameters' change over the three steps, measured the
               same way, over the leaves whose reference gradient is at
               least a thousandth of the median leaf's (a gradient below
               that moves its leaf under Adam by round-off alone)
  dparam1_gap  the same for the change over the first step
  dropout_z    where the program draws dropout: how many standard
               deviations its share of kept activations (among nonzero
               ones) lies from 1 - DROP_RATE
  sample_bad   sampled cells: the sampled blocks' violations of what a
               uniform neighbour sample guarantees (reference.check_sample),
               plus how far the sampled-edge count that the program's
               `train_epoch()` returned for the captured epochs lies from
               the kept slots the harness counted in those epochs' blocks;
               limit 0

The GAT cells compare loss1_gap and dparam1_gap beside loss_gap and
dparam_gap: there Adam's first update moves an element whose gradient is
round-off small by a learning rate whichever sign round-off gives it, and
the later steps' losses and changes follow that one element, so the
three-step numbers have wider limits and the first step's hold it tight
(PERF.md).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

NUMBERS = ("loss_gap", "loss1_gap", "grad1_gap", "grad1_median_diff",
           "dparam_gap", "dparam1_gap", "dropout_z", "sample_bad")
# leaves whose reference gradient lies under this share of the median
# leaf's are left out of dparam_gap
GRAD_FLOOR = 1e-3


class Inputs:
    """The graph on the device, as the reference reads it."""

    def __init__(self, arrays, device, ref_module):
        self.device = device
        self.V = int(arrays["features"].shape[0])
        e = torch.from_numpy(arrays["edges"]).to(device).long()
        self.src, self.dst = e[:, 0].contiguous(), e[:, 1].contiguous()
        self.x = torch.from_numpy(arrays["features"]).to(device)
        self.labels = torch.from_numpy(arrays["labels"]).to(device).long()
        self.train = torch.from_numpy(arrays["masks"] == 0).to(device)
        self.ind, self.outd = ref_module.degrees(self.src, self.dst, self.V)
        self.ref = ref_module


def step_inputs(inp: Inputs, cell, cap) -> List[dict]:
    """The reference's inputs for each captured step: features, edge lists
    in row space, dropout masks, the loss's rows and labels."""
    ref, cfg = inp.ref, cell.config
    out = []
    for i in range(len(cap.losses)):
        masks = list(cap.masks[i]) if i < len(cap.masks) else []
        if cell.mode == "sampled":
            layers = cap.layers[i]
            edges = ref.sampled_edges(cfg, layers, inp.V, inp.ind, inp.outd,
                                      inp.device)
            masks = [m[layers[l]["valid"]] for l, m in enumerate(masks)]
            top = layers[-1]["dst"]
            labels = inp.labels[top]
            rows = torch.arange(top.numel(), device=inp.device)
        else:
            edges = ref.whole_graph_edges(cfg, inp.src, inp.dst, inp.V,
                                          inp.ind, inp.outd)
            labels = inp.labels
            rows = torch.nonzero(inp.train)[:, 0]
        out.append({"x": inp.x, "edges": edges, "masks": masks,
                    "labels": labels, "rows": rows})
    return out


def _norms(ts) -> List[float]:
    return [float(t.double().norm()) for t in ts]


def norm_gap(prog: List[float], ref: List[float],
             leaves: Optional[List[int]] = None) -> float:
    """Largest |program norm - reference norm| / max(reference norm of the
    leaf, of the median leaf) over `leaves` (all by default)."""
    idx = list(range(len(ref))) if leaves is None else leaves
    if not idx:
        return 0.0
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-300) for i in idx)


def compare(prog: dict, ref: dict, p0: List[torch.Tensor]
            ) -> Dict[str, float]:
    """The step numbers of a program's steps (`prog`: losses, grad1,
    params1 and params after the first and the last step) against the
    reference's."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps = [math.inf]
    g_ref = _norms(ref["grad1"])
    med_g = statistics.median(g_ref)
    moved = [i for i, g in enumerate(g_ref) if g >= GRAD_FLOOR * med_g]

    def change_gap(key):
        d_prog = _norms([p.double() - q.double() for p, q in
                         zip(prog[key], p0)])
        d_ref = _norms([p.double() - q.double() for p, q in
                        zip(ref[key], p0)])
        return norm_gap(d_prog, d_ref, moved)

    d_grad = _norms([p.double() - r.double() for p, r in
                     zip(prog["grad1"], ref["grad1"])])
    return {"loss_gap": max(gaps), "loss1_gap": gaps[0],
            "grad1_gap": norm_gap(_norms(prog["grad1"]), g_ref),
            "grad1_median_diff": statistics.median(
                d / max(r, med_g, 1e-300) for d, r in zip(d_grad, g_ref)),
            "dparam_gap": change_gap("params"),
            "dparam1_gap": change_gap("params1")}


def program_steps(cfg: dict, cap) -> dict:
    """The program's side: its losses, its first gradient from its first
    moment (m1 = (1 - beta1) g), its parameters after three steps."""
    b1 = cfg["adam"]["beta1"]
    return {"losses": list(cap.losses),
            "grad1": [m.double() / (1.0 - b1) for m in cap.m1],
            "params1": list(cap.p1), "params": list(cap.p3)}


def dropout_z(cfg: dict, cap, expected: bool) -> float:
    """Standard deviations between the kept share of nonzero activations
    and 1 - DROP_RATE; infinite where dropout was expected and not seen,
    or seen and not expected."""
    p = float(cfg["drop_rate"])
    if not expected:
        return 0.0 if cap.drop_total == 0 else math.inf
    if cap.drop_total == 0 or not 0.0 < p < 1.0:
        return math.inf
    share = cap.drop_kept / cap.drop_total
    return abs(share - (1.0 - p)) / math.sqrt(p * (1.0 - p) / cap.drop_total)


def edge_count_gap(cap) -> int:
    """How far the program's sampled-edge counts (the numerator of its
    edge rate) lie from the kept slots of the same epochs' blocks, as the
    harness counted them on valid destination rows; the recorded steps'
    kept slots must also be the slots their layers keep (nbr >= 0), which
    check_sample judges."""
    if not cap.epoch_edges or len(cap.step_kept) < len(cap.layers):
        return 1
    recorded = sum(int((l["nbr"] >= 0).sum()) for layers in cap.layers
                   for l in layers)
    counted = sum(cap.step_kept[:len(cap.layers)])
    return (abs(sum(cap.epoch_edges) - sum(cap.step_kept))
            + abs(recorded - counted))


def judge(cell, inp: Inputs, cap, precision: str = "float64",
          as_program: Optional[str] = None) -> Dict[str, float]:
    """Every number `correct` compares for one captured run.

    `as_program` puts the reference in the program's place: "control" is
    the reference in TF32 (the precision below the configuration's);
    "half_batch" the reference with its loss averaged over half the
    batch, "state_unchanged" the reference whose steps return their state
    unchanged (two faults); the sample and dropout numbers stay the
    program's."""
    ref_mod, cfg = inp.ref, cell.config
    bc = bool(cell.workload["adam_bias_correction"])
    p0 = cap.p0   # the program's leaves, in the order the module declares
    steps = step_inputs(inp, cell, cap)
    ref = ref_mod.train_steps(cfg, bc, p0, steps, precision)
    if as_program is None:
        prog = program_steps(cfg, cap)
    elif as_program == "control":
        prog = ref_mod.train_steps(cfg, bc, p0, steps, "tf32")
    elif as_program in ("half_batch", "state_unchanged"):
        prog = ref_mod.train_steps(cfg, bc, p0, steps, precision,
                                   half_batch=as_program == "half_batch",
                                   frozen=as_program == "state_unchanged")
    else:
        raise ValueError(f"unknown stand-in {as_program!r}")
    out = compare(prog, ref, cap.p0)
    out["dropout_z"] = dropout_z(cfg, cap, bool(cell.workload["dropout"]))
    if cell.mode == "sampled":
        bad = [ref_mod.check_sample(
            [{"dst": l["dst"], "nbr": l["nbr"]} for l in layers], inp.src,
            inp.dst, inp.V, inp.train) for layers in cap.layers]
        seeds = torch.cat([layers[-1]["dst"] for layers in cap.layers])
        repeated = seeds.numel() - torch.unique(seeds).numel()
        out["sample_bad"] = float(sum(sum(b.values()) for b in bad)
                                  + repeated + edge_count_gap(cap))
    return out


def checks(numbers: Dict[str, float], limits: Dict[str, float]
           ) -> Dict[str, dict]:
    """Each number the cell compares (those its limits name) beside its
    limit, in NUMBERS' order; a named number the run could not read is
    infinite, and fails."""
    return {k: {"value": numbers.get(k, math.inf), "limit": limits[k]}
            for k in NUMBERS if k in limits}


def passed(checked: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())
