"""What one cell is, found by the names in `BENCHMARK.json`.

Everything that belongs to one configuration, traffic mix, cell or metric
sits in a file of its own under `benchmark/`, named after it:

    configs/<config>.json     the configuration (BENCHMARK.json's `file`)
    traffic/<traffic>.json    the traffic mix's parameters
    workloads/<cell>.json     the engine the cell drives, and the update
                              rule and reference module that check it
    limits/<cell>.json        the limit of each number `correct` compares
    metrics/<metric>.py       the reader of one metric, `read(ctx)`
    reference/<module>.py     a plain reference, named by the cell's file;
                              also all the harness knows of the
                              architecture (its parameter leaves, FLOPs
                              and kernel shapes)

so a later change adds a configuration, a cell or a metric by adding
files and entries, without editing a file that is there.  A
configuration's optional `program` group holds keys handed to the
program's RunConfig as they are.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of `workloads` with every file it names, loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    # the plain reference module the workload file names, loaded with the
    # cell: the architecture's leaves, FLOPs and kernel shapes come from it
    reference: ModuleType

    @property
    def mode(self) -> str:
        return self.traffic["mode"]


def _for_cell(metrics: List[dict], cell: str,
              reported: Optional[set] = None) -> List[dict]:
    """The metrics a cell reports: those listing it under `workloads`, or
    without the key those moving an end-to-end metric the cell reports
    (every cell, for an end-to-end metric)."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json",
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell called `name`; KeyError naming the cells there are."""
    spec = _load_json(bench_file)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; there are {sorted(cells)}")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = _for_cell(spec["end_to_end"], name)
    per_layer = _for_cell(spec["per_layer"], name,
                          reported={m["name"] for m in e2e})
    workload = _load_json(bench_dir / "workloads" / f"{name}.json")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_load_json(bench_file.parent / cfg_entry["file"]),
        traffic=_load_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
        workload=workload,
        limits=_load_json(bench_dir / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer,
        reference=reference_module(workload["reference"], bench_dir))


def _load_module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(metric: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The module whose `read(ctx)` gives the metric called `metric`."""
    return _load_module(bench_dir / "metrics" / f"{metric}.py",
                        f"benchmark_metric_{metric.replace('.', '_')}")


def reference_module(name: str, bench_dir: Path = BENCH_DIR) -> ModuleType:
    """The plain reference module named by a cell's workload file."""
    return _load_module(bench_dir / "reference" / f"{name}.py",
                        f"benchmark_reference_{name}")


def read_metrics(metrics: List[dict], ctx,
                 bench_dir: Path = BENCH_DIR) -> Dict[str, dict]:
    """Each metric's reading as {"value", "unit"}; a reader that finds
    nothing to read returns None and the metric is left out."""
    out = {}
    for m in metrics:
        value = metric_reader(m["name"], bench_dir).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
