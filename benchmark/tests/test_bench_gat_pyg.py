"""The gat_products configuration's reference module (`reference/
gat_pyg.py`, PyG's ogbn-products GAT) passes what the harness asks of an
architecture from its own files: its leaves are the program's, at the
published widths 15 of them with 751,574 parameters, its FLOPs are the
GAT layer's count at W's columns plus the skips, its kernel shapes the
layers' (F, H); a tiny copy of the cell (three layers, fan-out 3-3-3) is
`correct` on the CPU and the planted faults and the control are not; the
epilogue's reader reads the program's `epilogue` spans a step."""

from __future__ import annotations

import io
import json
import math
import types

import pytest
import torch

from benchmark import correctness, graph, program, readings, run, spans, spec
from benchmark.tests import tiny
from benchmark.trace import Event, TraceData

CELL = "gat_products.sampled"
TINY_WIDTHS = [24, 16, 16, 5]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The tiny copy of every cell, with this cell three layers deep."""
    bench_file, bench_dir = tiny.make(tmp_path_factory.mktemp("tiny"))
    cfg_path = bench_dir / "configs" / "gat_products.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["layer_sizes"] = TINY_WIDTHS
    cfg_path.write_text(json.dumps(cfg))
    traffic_path = bench_dir / "traffic" / "sampled_10x3_b512.json"
    traffic = json.loads(traffic_path.read_text())
    traffic.update(fanout=[3, 3, 3], batch_size=32)
    traffic_path.write_text(json.dumps(traffic))
    return bench_file, bench_dir


def _published():
    return spec.load_cell(CELL)


def test_the_published_widths():
    cell = _published()
    ref, cfg = cell.reference, cell.config
    decl = ref.leaves(cfg)
    assert len(decl) == 15
    assert sum(math.prod(shape) for _, shape, _ in decl) == 751_574
    assert ref.kernel_layers(cfg) == [(512, 4), (512, 4), (188, 4)]
    assert ref.reads_own_rows(cfg)
    assert cfg["published"]["parameters"] == 751_574
    g = cfg["graph"]
    train = int(g["vertices"] * g["train_frac"])
    val = int(g["vertices"] * g["val_end_frac"]) - train
    assert [train, val, g["vertices"] - train - val] == cfg["published"][
        "split"]


def test_the_flops_are_the_gat_layers_at_ws_columns_and_the_skips():
    cell = _published()
    gnn = spec.reference_module("gnn")
    steps = [(40_000, 5_000, 50_000), (5_000, 512, 5_000), (4_000, 512, 900)]
    att = gnn.step_flops({"family": "gat", "layer_sizes": [100, 512, 512,
                                                           188]}, steps)
    skips = sum((3 if l else 2) * 2 * dv * fin * fout for l, ((_, dv, _), fin,
                fout) in enumerate(zip(steps, [100, 512, 512],
                                       [512, 512, 47])))
    assert cell.reference.step_flops(cell.config, steps) == att + skips
    assert cell.reference.epoch_flops(cell.config, 10, 50) == (
        cell.reference.step_flops(cell.config, [(50, 10, 10)] * 3))


def test_the_module_declares_the_programs_leaves(files):
    bench_file, bench_dir = files
    cell = spec.load_cell(CELL, bench_file, bench_dir)
    arrays = graph.load_graph(cell.config["graph"],
                              bench_dir.parent / "graphs")
    trainer = program.build(cell, 5, program.make_dataset(arrays, "t"),
                            "cpu")
    p0 = program.make_weights(cell, 2_147_483_659, "cpu")
    assert [tuple(t.shape) for t in p0] == [
        tuple(t.shape) for t in trainer.params.leaves()]
    assert all(t.abs().max() > 0 for t in p0)
    program.set_weights(trainer, p0)
    assert all(torch.equal(a, b) for a, b in zip(trainer.params.leaves(),
                                                 p0))


class _Frozen:
    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        return list(params), state


def _first_half(valid):
    order = torch.cumsum(valid.long(), 0)
    return valid & (order <= (int(valid.sum()) + 1) // 2)


@pytest.mark.parametrize("fault", ["none", "state_unchanged", "half_batch"])
def test_the_tiny_cell_is_correct_and_a_planted_fault_is_not(
        files, fault, monkeypatch):
    bench_file, bench_dir = files
    after = None
    if fault == "state_unchanged":
        def after(trainer):
            trainer.optimizer = _Frozen(trainer.optimizer)
    elif fault == "half_batch":
        import sgnn_tpu_torch.train.trainer as trainer_mod

        orig = trainer_mod.nll_loss_masked
        monkeypatch.setattr(
            trainer_mod, "nll_loss_masked",
            lambda logp, labels, valid: orig(logp, labels,
                                             _first_half(valid)))
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(run.parse_args(["--workload", CELL, "--seed", "2147483659",
                                 "--seconds", "0.3", "--trace", "0"]),
                 run.Options(bench_file=bench_file, bench_dir=bench_dir,
                             graph_cache=bench_dir.parent / "graphs",
                             device="cpu", require_chip=False,
                             after_build=after), out, err)
    assert rc == 0, err.getvalue()[-2000:]
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["correct"] == (fault == "none"), last["checks"]
    assert set(last["checks"]) == set(correctness.NUMBERS)


def test_the_control_in_the_programs_place_is_not_correct(files):
    bench_file, bench_dir = files
    c = spec.load_cell(CELL, bench_file, bench_dir)
    arrays = graph.load_graph(c.config["graph"], bench_dir.parent / "graphs")
    trainer = program.build(c, 77, program.make_dataset(arrays, "t"), "cpu")
    program.set_weights(trainer, program.make_weights(c, 77, "cpu"))
    cap = program.CAPTURES[c.mode](c, trainer)
    inp = correctness.Inputs(arrays, "cpu", c.reference)
    sound = correctness.checks(correctness.judge(c, inp, cap), c.limits)
    control = correctness.checks(
        correctness.judge(c, inp, cap, as_program="control"), c.limits)
    assert correctness.passed(sound), sound
    assert not correctness.passed(control), control


def _span(i, name, a, b, parent=None, step=None, ms=None):
    return {"id": i, "name": name, "parent": parent, "epoch": 0,
            "step": step, "thread": 1, "start_ns": a, "end_ns": b,
            "device": ms is not None, "device_ms": ms}


def test_the_epilogue_reader_sums_a_steps_spans(monkeypatch):
    cell = _published()
    win = types.SimpleNamespace(seconds=1e-6, span_ns=(0, 1000), epochs=[
        types.SimpleNamespace(steps=2, step_ms=[], edges=0, loss=1.0)])
    ctx = readings.Context(cell=cell, setup_s=1.0, window=win,
                           device_name="NVIDIA H100 80GB HBM3",
                           num_vertices=600, num_edges=4800,
                           trace=TraceData([Event("k", 0, 900)], [],
                                           (0, 1000)))
    reader = spec.metric_reader("model.epilogue_ms_per_step.sampled")
    monkeypatch.setattr(spans, "recorded", lambda: [
        _span(1, "forward", 0, 400, step=0, ms=9.0),
        *(_span(2 + l, "epilogue", 100 * l, 100 * l + 50, 1, 0, 0.5 + l)
          for l in range(3)),
        _span(5, "forward", 500, 900, step=1, ms=9.0),
        *(_span(6 + l, "epilogue", 500 + 100 * l, 550 + 100 * l, 5, 1, 1.0)
          for l in range(3))])
    assert reader.read(ctx) == pytest.approx((0.5 + 1.5 + 2.5 + 3.0) / 2)
    monkeypatch.setattr(spans, "recorded", lambda: [
        _span(1, "forward", 0, 400, step=0, ms=9.0)])
    assert reader.read(ctx) is None
