"""A tiny copy of the benchmark's files, for running the rest of a run on
the CPU: the same cells and metrics over a 600-vertex graph and narrow
layers, in a temporary directory beside links to the real readers and
reference."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark import spec

BENCH = spec.ROOT / "BENCHMARK.json"
HELD = spec.BENCH_DIR / "held.json"

GRAPH = {"generator": "planted_community", "vertices": 600,
         "avg_in_degree": 8, "features": 24, "classes": 5,
         "intra_frac": 0.7, "alpha": 0.8, "feature_snr": 0.5, "seed": 0,
         "train_frac": 0.66, "val_end_frac": 0.76}


def with_held(bench: dict) -> dict:
    """BENCHMARK.json's entries with those held out of it
    (benchmark/held.json) put in: the cells whose files are kept and
    tested though no bound holds them yet."""
    b = copy.deepcopy(bench)
    held = json.loads(HELD.read_text())
    b["workloads"] += held["workloads"]
    b["end_to_end"] += held["end_to_end"]
    have = {m["name"]: m for m in b["per_layer"]}
    for m in held["per_layer"]:
        if m["name"] in have:
            # a metric read in cells of both: one entry listing them all
            have[m["name"]]["workloads"] += m["workloads"]
        else:
            b["per_layer"].append(copy.deepcopy(m))
    for m in b["end_to_end"] + b["per_layer"]:
        m.get("workloads", []).extend(
            held["add_to_workloads"].get(m["name"], []))
    return b


def whole(tmp: Path) -> Path:
    """A BENCHMARK.json with the held entries in, beside a link to the
    real benchmark directory."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "benchmark").symlink_to(spec.BENCH_DIR)
    (tmp / "BENCHMARK.json").write_text(
        json.dumps(with_held(json.loads(BENCH.read_text()))))
    return tmp / "BENCHMARK.json"


def make(tmp: Path, limits=None) -> "tuple[Path, Path]":
    """(BENCHMARK.json, benchmark dir) of the tiny copy under `tmp`, the
    held cells in."""
    real = with_held(json.loads(BENCH.read_text()))
    d = tmp / "benchmark"
    for sub in ("configs", "traffic", "workloads", "limits"):
        (d / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("metrics", "reference"):
        (d / sub).symlink_to(spec.BENCH_DIR / sub)
    bench = copy.deepcopy(real)
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        cfg["layer_sizes"] = [24, 16, 5]
        cfg["graph"] = dict(GRAPH)
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        src = spec.BENCH_DIR / "workloads" / f"{w['name']}.json"
        (d / "workloads" / src.name).write_text(src.read_text())
        lim = json.loads((spec.BENCH_DIR / "limits" / src.name).read_text())
        lim.update(limits or {})
        (d / "limits" / src.name).write_text(json.dumps(lim))
    for t in {w["traffic"] for w in bench["workloads"]}:
        traffic = json.loads((spec.BENCH_DIR / "traffic" /
                              f"{t}.json").read_text())
        if traffic["mode"] == "sampled":
            traffic.update(fanout=[5, 3], batch_size=64)
        (d / "traffic" / f"{t}.json").write_text(json.dumps(traffic))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp / "BENCHMARK.json", d
