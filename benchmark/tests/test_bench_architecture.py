"""The architecture comes from the cell's reference module alone.

Against frozen copies of what the harness computed before the module
declared it (the weights' draw, the step and epoch FLOP counts, the
`correct` numbers of the tiny cells), and through a test-only
architecture (`gcn_bias.py` beside this file: a bias leaf on every layer
and a `program` key) that passes from its own files alone through the
draw, a stub trainer's leaves, `correctness.judge` and its own steps."""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import shutil
import types

import pytest
import torch

from benchmark import bounds, correctness, graph, program, readings, spec
from benchmark.tests import tiny
from benchmark.trace import Event, TraceData

H100 = "NVIDIA H100 80GB HBM3"
V, E = 232_965, 11_880_013


# ------------------------------------------------- frozen: before the module
def _frozen_make_weights(cell, seed, device):
    """The draw as the harness made it before: every W_l [in, out] and,
    for GAT, every a_l [2 out, 1], from one torch.rand."""
    sizes = cell.config["layer_sizes"]
    shapes = [(sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)]
    if cell.config["family"] == "gat":
        shapes += [(2 * sizes[i + 1], 1) for i in range(len(sizes) - 1)]
    total = sum(a * b for a, b in shapes)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32) * 2.0 - 1.0
    leaves, off = [], 0
    for a, b in shapes:
        bound = math.sqrt(6.0 / (a + b))
        leaves.append((flat[off:off + a * b] * bound).view(a, b).clone())
        off += a * b
    n = len(sizes) - 1
    return {"weights": leaves[:n], "attn": leaves[n:]}


_FROZEN_LAYER_FLOPS = {"gcn": bounds.gcn_layer_flops,
                       "gat": bounds.gat_layer_flops}


def _frozen_step_flops(family, widths, layers):
    fn = _FROZEN_LAYER_FLOPS[family]
    return sum(fn(nnz, dv, sv, widths[l], widths[l + 1], l > 0)
               for l, (nnz, dv, sv) in enumerate(layers))


@pytest.mark.parametrize("cell", ["gcn_reddit.fullgraph",
                                  "gat_reddit.fullgraph"])
def test_the_draw_is_the_frozen_draw_bit_for_bit(cell):
    c = spec.load_cell(cell)
    for seed in (0, 2_147_483_659):
        old = _frozen_make_weights(c, seed, "cpu")
        new = program.make_weights(c, seed, "cpu")
        flat = old["weights"] + old["attn"]
        assert len(new) == len(flat)
        for a, b in zip(new, flat):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert torch.equal(a, b)


@pytest.mark.parametrize("family", ["gcn", "gat"])
@pytest.mark.parametrize("widths,steps", [
    ([24, 16, 5], [[(300, 64, 200), (120, 40, 64)],
                   [(17, 5, 12), (5, 1, 5)]]),
    ([602, 128, 41], [[(1_100_000, 110_000, 230_000),
                       (240_000, 10_000, 110_000)],
                      [(400_000, 60_000, 150_000),
                       (90_000, 3_756, 60_000)]]),
])
def test_flops_equal_the_frozen_counts(family, widths, steps):
    gnn = spec.reference_module("gnn")
    cfg = {"family": family, "layer_sizes": widths, "heads": 4}
    for layers in steps:
        assert gnn.step_flops(cfg, layers) == _frozen_step_flops(
            family, widths, layers)
    for v, e in ((600, 5_400), (V, E)):
        assert gnn.epoch_flops(cfg, v, e) == _frozen_step_flops(
            family, widths, [(e, v, v)] * (len(widths) - 1))


def test_kernel_layers_are_the_frozen_shapes():
    gnn = spec.reference_module("gnn")
    assert gnn.kernel_layers({"family": "gat", "heads": 4,
                              "layer_sizes": [602, 128, 41]}) == [
        (128, 4), (41, 1)]
    assert gnn.kernel_layers({"family": "gcn", "heads": 1,
                              "layer_sizes": [602, 128, 41]}) == [
        (128, 1), (41, 1)]
    assert gnn.reads_own_rows({"family": "gat"})
    assert not gnn.reads_own_rows({"family": "gcn"})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", ["gcn_reddit.sampled",
                                  "gat_reddit.fullgraph",
                                  "gcn_reddit.fullgraph",
                                  "gat_reddit.sampled"])
def test_tiny_cells_numbers_equal_those_of_the_frozen_draw(files, cell):
    """The numbers `correct` compares, from the module's draw, are those
    of the frozen draw put in as the harness put it before (weights then
    attention vectors)."""
    bench_file, bench_dir = files
    c = spec.load_cell(cell, bench_file, bench_dir)
    arrays = graph.load_graph(c.config["graph"], bench_dir.parent / "graphs")
    inp = correctness.Inputs(arrays, "cpu", c.reference)
    got = []
    for frozen in (True, False):
        trainer = program.build(c, 41, program.make_dataset(arrays, "t"),
                                "cpu")
        if frozen:
            old = _frozen_make_weights(c, 41, "cpu")
            core = program.core(trainer)
            core.params = core.params.replace_leaves(
                [t.clone() for t in old["weights"] + old["attn"]])
        else:
            program.set_weights(trainer, program.make_weights(c, 41, "cpu"))
        cap = program.CAPTURES[c.mode](c, trainer)
        got.append(correctness.judge(c, inp, cap))
    assert got[0] == got[1]
    assert correctness.passed(correctness.checks(got[1], c.limits))


def test_the_gat_sampled_group_bound_is_the_ports():
    from sgnn_tpu_torch.utils import roofline

    shapes = {"layers": 2, "D0": 233_088, "K0": 10, "S0": 233_088,
              "F0": 128, "H0": 4, "nnz0": 1_900_000, "D1": 10_112, "K1": 25,
              "S1": 233_088, "F1": 41, "H1": 1, "nnz1": 240_000}
    want = 0.0
    for l in range(2):
        kw = {k: shapes[f"{k}{l}"] for k in ("D", "K", "S", "F", "H", "nnz")}
        for kernel in ("gat_sampled_fwd", "gat_sampled_bwd"):
            want += roofline.kernel_bound(kernel, H100, 4, **kw)["bound_ms"]
    got = bounds.kernel_bounds_per_step("gat_sampled", H100, 4, shapes)
    assert got * 1e3 == pytest.approx(want)


# ------------------------------------------------ a test-only architecture
class _StubParams:
    """The program's parameter container as the harness meets it."""

    def __init__(self, leaves):
        self._leaves = list(leaves)

    def leaves(self):
        return list(self._leaves)

    def replace_leaves(self, leaves):
        return _StubParams(leaves)


@pytest.fixture(scope="module")
def biased(tmp_path_factory):
    """A repo of one cell whose configuration, reference module, limits
    and entries are files of their own."""
    root = tmp_path_factory.mktemp("biased")
    d = root / "benchmark"
    for sub in ("configs", "traffic", "workloads", "limits", "reference"):
        (d / sub).mkdir(parents=True)
    (d / "metrics").symlink_to(spec.BENCH_DIR / "metrics")
    shutil.copy(spec.BENCH_DIR / "tests" / "gcn_bias.py",
                d / "reference" / "gcn_bias.py")
    cfg = json.loads((spec.BENCH_DIR / "configs" / "gcn_reddit.json")
                     .read_text())
    cfg.update(name="gcnb", layer_sizes=[24, 16, 5], graph=dict(tiny.GRAPH),
               program={"time_skip": 5})
    (d / "configs" / "gcnb.json").write_text(json.dumps(cfg))
    (d / "traffic" / "fullgraph.json").write_text(
        (spec.BENCH_DIR / "traffic" / "fullgraph.json").read_text())
    (d / "workloads" / "gcnb.fullgraph.json").write_text(json.dumps(
        {"algorithm": "GCNFULLBATCH", "adam_bias_correction": True,
         "dropout": False, "reference": "gcn_bias"}))
    (d / "limits" / "gcnb.fullgraph.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad1_gap": 1e-4, "dparam_gap": 1e-3}))
    real = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench = copy.deepcopy(real)
    bench["configs"] = [{"name": "gcnb", "source": "https://example.org",
                         "file": "benchmark/configs/gcnb.json",
                         "reduced": [], "why": "a bias on every layer"}]
    bench["workloads"] = [{"name": "gcnb.fullgraph", "config": "gcnb",
                           "traffic": "fullgraph", "chips": 1,
                           "why": "whole-graph GCN with biases"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = (["gcnb.fullgraph"] if m["name"] in (
                "fullgraph_epoch_ms", "step.mfu_pct.fullgraph") else [])
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("gcnb.fullgraph", root / "BENCHMARK.json", d)
    arrays = graph.load_graph(cfg["graph"], root / "graphs")
    return cell, arrays


def test_no_harness_file_names_the_test_architecture():
    for path in spec.BENCH_DIR.rglob("*"):
        if path.is_file() and "tests" not in path.relative_to(
                spec.BENCH_DIR).parts and "__pycache__" not in path.parts:
            assert "gcn_bias" not in path.read_text(errors="ignore"), path


def test_the_configurations_program_keys_reach_run_config(biased):
    cell, _ = biased
    assert program.run_config(cell, 5, 600).time_skip == 5
    bad = dataclasses.replace(cell, config=dict(
        cell.config, program={"time_skip": 5, "no_such_knob": 1}))
    with pytest.raises(ValueError, match="no_such_knob"):
        program.run_config(bad, 5, 600)


def test_the_draw_and_a_stub_trainers_leaves(biased):
    cell, _ = biased
    p0 = program.make_weights(cell, 2_147_483_659, "cpu")
    assert [tuple(t.shape) for t in p0] == [(24, 16), (16,), (16, 5), (5,)]
    assert not p0[1].any() and not p0[3].any()
    assert 0 < p0[0].abs().max() <= math.sqrt(6 / 40)
    assert torch.equal(p0[2], program.make_weights(cell, 2_147_483_659,
                                                   "cpu")[2])
    trainer = types.SimpleNamespace(params=_StubParams(
        torch.ones(t.shape) for t in p0))
    program.set_weights(trainer, p0)
    assert all(torch.equal(a, b) for a, b in zip(trainer.params.leaves(),
                                                 p0))
    no_bias = types.SimpleNamespace(params=_StubParams(p0[::2]))
    with pytest.raises(ValueError, match="declares"):
        program.set_weights(no_bias, p0)


def _biased_capture(cell, inp, p0):
    """A program stand-in: the module's own steps in float32, as a run
    captures a program's (losses, first moment, parameters)."""
    cap = program.Capture(losses=[0.0] * program.CAPTURE_STEPS, p0=p0)
    steps = correctness.step_inputs(inp, cell, cap)
    own = cell.reference.train_steps(cell.config, True, p0, steps,
                                     "float32")
    b1 = cell.config["adam"]["beta1"]
    cap.losses = own["losses"]
    cap.m1 = [(1.0 - b1) * g for g in own["grad1"]]
    cap.p1, cap.p3 = own["params1"], own["params"]
    return cap


def test_the_test_architecture_is_judged_from_its_own_files(biased):
    cell, arrays = biased
    inp = correctness.Inputs(arrays, "cpu", cell.reference)
    p0 = program.make_weights(cell, 7, "cpu")
    cap = _biased_capture(cell, inp, p0)
    sound = correctness.checks(correctness.judge(cell, inp, cap),
                               cell.limits)
    assert correctness.passed(sound), sound
    # a step that leaves the bias leaves where they were
    cap.p1 = [p0[i] if i % 2 else t for i, t in enumerate(cap.p1)]
    cap.p3 = [p0[i] if i % 2 else t for i, t in enumerate(cap.p3)]
    unmoved = correctness.checks(correctness.judge(cell, inp, cap),
                                 cell.limits)
    assert not correctness.passed(unmoved), unmoved
    # the module's own fault stands in for the program
    half = correctness.checks(correctness.judge(
        cell, inp, _biased_capture(cell, inp, p0), as_program="half_batch"),
        cell.limits)
    assert not correctness.passed(half), half


def test_the_readings_take_the_test_architectures_flops(biased):
    cell, _ = biased
    win = types.SimpleNamespace(seconds=0.01, epochs=[types.SimpleNamespace(
        steps=1, step_ms=[], edges=0, loss=1.0)] * 3)
    ctx = readings.Context(cell=cell, setup_s=1.0, window=win,
                           device_name=H100, num_vertices=600,
                           num_edges=5_400,
                           trace=TraceData([Event("k", 0, 10)], [],
                                           (0, 10**7)))
    assert ctx.kernel_layers == [(16, 1), (5, 1)]
    assert readings.step_flops_total(ctx) == 3 * cell.reference.epoch_flops(
        cell.config, 600, 5_400)
    assert readings.mfu_pct(ctx, "fullgraph") == pytest.approx(
        100 * 3 * cell.reference.epoch_flops(cell.config, 600, 5_400)
        / 0.01 / 67e12)
