"""BENCHMARK.json against the rules of its format, the harness's lookup of
every cell, configuration and metric by name, and the imports the
yardstick may not make."""

from __future__ import annotations

import ast
import copy
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == KEYS
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def _one_line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_entries_have_the_format_keys_and_names():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("benchmark/")
        assert (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _one_line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        for e in BENCH[group]:
            assert NAME.match(e["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"])
        assert m["name"] not in names
        names.add(m["name"])
    assert any(m["name"] == "setup_s" and "workloads" not in m
               and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_every_name_has_its_files():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.mode in ("sampled", "fullgraph")
        spec.reference_module(cell.workload["reference"])
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)


def test_files_under_paths_are_named_from_name_characters():
    for p in spec.BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
        assert len(rel) <= 200


def test_configs_cut_no_width_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["layer_sizes"] == [602, 128, 41]
        assert cfg["graph"]["features"] == cfg["layer_sizes"][0]
        assert cfg["graph"]["classes"] == cfg["layer_sizes"][-1]
        assert cfg["graph"]["vertices"] == cfg["published"]["vertices"]


def test_a_new_cell_config_and_metric_come_from_new_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries: nothing that is there is
    edited."""
    root = tmp_path / "repo"
    bench_dir = root / "benchmark"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    b = copy.deepcopy(BENCH)
    cfg = json.loads((spec.ROOT / b["configs"][0]["file"]).read_text())
    cfg["name"] = "gcn_other"
    (bench_dir / "configs" / "gcn_other.json").write_text(json.dumps(cfg))
    b["configs"].append({"name": "gcn_other", "source": "https://example.org",
                         "file": "benchmark/configs/gcn_other.json",
                         "reduced": [], "why": "another deployment"})
    (bench_dir / "traffic" / "sampled_small.json").write_text(json.dumps(
        {"mode": "sampled", "fanout": [10, 5], "batch_size": 1024,
         "batch_type": "shuffle", "trace_seconds": 3}))
    (bench_dir / "workloads" / "gcn_other.sampled_small.json").write_text(
        json.dumps({"algorithm": "GCNSAMPLEALLGPU", "reference": "gnn",
                    "adam_bias_correction": False, "dropout": True}))
    (bench_dir / "limits" / "gcn_other.sampled_small.json").write_text(
        (spec.BENCH_DIR / "limits" / "gcn_reddit.sampled.json").read_text())
    (bench_dir / "metrics" / "step.count.sampled.py").write_text(
        "def read(ctx):\n    return ctx.steps\n")
    b["workloads"].append({"name": "gcn_other.sampled_small",
                           "config": "gcn_other", "traffic": "sampled_small",
                           "chips": 1, "why": "smaller batches"})
    for m in b["end_to_end"]:
        if "workloads" in m and "gat_reddit.sampled" in m["workloads"]:
            m["workloads"].append("gcn_other.sampled_small")
    b["per_layer"].append({"name": "step.count.sampled", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "train step", "moves":
                           "sampled_edges_per_s",
                           "workloads": ["gcn_other.sampled_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("gcn_other.sampled_small", root / "BENCHMARK.json",
                          bench_dir)
    assert cell.config["name"] == "gcn_other"
    assert cell.traffic["batch_size"] == 1024
    assert "step.count.sampled" in {m["name"] for m in cell.per_layer}

    class Ctx:
        steps = 7

    assert spec.read_metrics([m for m in cell.per_layer
                              if m["name"] == "step.count.sampled"], Ctx(),
                             bench_dir)["step.count.sampled"]["value"] == 7
    after = {p: p.read_bytes() for p in before}
    assert after == before


def _top_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and \
                node.module:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_or_the_jax_package():
    """Top-level names compared whole: sgnn_tpu_torch begins with
    sgnn_tpu and is allowed outside the reference."""
    for path in spec.BENCH_DIR.rglob("*.py"):
        names = set(_top_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "sgnn_tpu"}, path


def test_the_reference_imports_nothing_of_the_program():
    """A reference module imports nothing of the program, and of the
    harness only its FLOP formulas (`from benchmark import bounds`)."""
    for path in (spec.BENCH_DIR / "reference").rglob("*.py"):
        names = set(_top_imports(path))
        assert "sgnn_tpu_torch" not in names, path
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert not any(a.name.split(".")[0] == "benchmark"
                               for a in node.names), path
            elif isinstance(node, ast.ImportFrom) and node.module and \
                    node.module.split(".")[0] == "benchmark":
                assert node.module == "benchmark" and [
                    a.name for a in node.names] == ["bounds"], path


def test_the_forbidden_module_check_compares_whole_names(monkeypatch):
    import sys

    from benchmark import run

    monkeypatch.setitem(sys.modules, "sgnn_tpu_torch_x", object())
    assert run.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_loaded() == ["jax"]


@pytest.mark.parametrize("argv", [["--workload", "no.such", "--seed", "1",
                                   "--seconds", "1", "--trace", "0"]])
def test_an_unknown_cell_exits_without_a_result(argv, capsys):
    from benchmark import run

    assert run.main(argv) == 2
    assert capsys.readouterr().out == ""


def test_held_cells_come_back_by_entries_alone(tmp_path):
    """A cell held out of BENCHMARK.json keeps its files; putting its
    entries back makes a cell that reports setup_s, another end-to-end
    metric and a layer, each with its reader."""
    from benchmark.tests import tiny

    held = json.loads(tiny.HELD.read_text())
    names = {w["name"] for w in BENCH["workloads"]}
    bench_file = tiny.whole(tmp_path)
    for w in held["workloads"]:
        assert w["name"] not in names
        cell = spec.load_cell(w["name"], bench_file)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]).read)
    for m in held["end_to_end"] + held["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)
