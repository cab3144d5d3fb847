"""`correct` on the CPU at a tiny size: the rest of a run (the chip check
skipped, the kernels' plain versions) comes out correct for the program
as it is, and not correct with the timed path broken underneath (a step
that leaves its state unchanged; half of the batch left out, the mean
taken over the rest) or with the control (the reference in TF32) in the
program's place.  The limits are the cells' own."""

from __future__ import annotations

import io
import json

import pytest
import torch

from benchmark import correctness, graph, program, run, spec
from benchmark.tests import tiny

CELLS = ["gcn_reddit.sampled", "gat_reddit.fullgraph",
         "gcn_reddit.fullgraph", "gat_reddit.sampled"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("tiny"))


def _run(files, cell, after_build=None, trace=0, seed=2147483659):
    bench_file, bench_dir = files
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(run.parse_args(["--workload", cell, "--seed", str(seed),
                                 "--seconds", "0.3", "--trace", str(trace)]),
                 run.Options(bench_file=bench_file, bench_dir=bench_dir,
                             graph_cache=bench_dir.parent / "graphs",
                             device="cpu", require_chip=False,
                             after_build=after_build), out, err)
    assert rc == 0, err.getvalue()[-2000:]
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    return last, err.getvalue()


class _Frozen:
    """An optimizer whose step returns the parameters and state as they
    were."""

    def __init__(self, inner):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def update(self, grads, state, params):
        return list(params), state


def _state_unchanged(trainer):
    core = program.core(trainer)
    core.optimizer = _Frozen(core.optimizer)


def _first_half(valid):
    order = torch.cumsum(valid.long(), 0)
    return valid & (order <= (int(valid.sum()) + 1) // 2)


@pytest.mark.parametrize("cell", CELLS)
def test_the_program_as_it_is_is_correct(files, cell):
    last, err = _run(files, cell)
    assert last["correct"], last["checks"]
    assert list(last)[-1] == "checks"
    assert set(last) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert last["attempted"] > 0 and last["failed"] == 0
    # the compared numbers are the last lines of standard error too
    tail = err.strip().splitlines()[-len(last["checks"]):]
    assert [line.split()[1] for line in tail] == list(last["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_its_state_unchanged_is_not_correct(files, cell):
    last, _ = _run(files, cell, after_build=_state_unchanged)
    assert not last["correct"], last["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out_is_not_correct(files, cell, monkeypatch):
    if cell.endswith("sampled"):
        import sgnn_tpu_torch.train.trainer as trainer_mod

        orig = trainer_mod.nll_loss_masked
        monkeypatch.setattr(
            trainer_mod, "nll_loss_masked",
            lambda logp, labels, valid: orig(logp, labels,
                                             _first_half(valid)))
        after = None
    else:
        def after(trainer):
            b = trainer.base
            b.masks[0] = _first_half(b.masks[0])
            b.mask_counts[0] = b.masks[0].sum().float()
    last, _ = _run(files, cell, after_build=after)
    assert not last["correct"], last["checks"]


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith("sampled")])
def test_an_edge_count_with_padding_in_it_is_not_correct(files, cell,
                                                         monkeypatch):
    """The numerator of the edge rate is the program's count; a count
    that takes in the padding slots is caught against the blocks."""
    from sgnn_tpu_torch.sampler.blocks import SampledBatch

    monkeypatch.setattr(
        SampledBatch, "num_sampled_edges",
        lambda self: sum(torch.tensor(b.weight.numel()) for b in
                         self.blocks))
    last, _ = _run(files, cell)
    assert not last["correct"], last["checks"]
    assert last["checks"]["sample_bad"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(files, cell):
    bench_file, bench_dir = files
    c = spec.load_cell(cell, bench_file, bench_dir)
    arrays = graph.load_graph(c.config["graph"], bench_dir.parent / "graphs")
    ds = program.make_dataset(arrays, c.config["name"])
    trainer = program.build(c, 77, ds, "cpu")
    program.set_weights(trainer, program.make_weights(c, 77, "cpu"))
    cap = program.CAPTURES[c.mode](c, trainer)
    inp = correctness.Inputs(arrays, "cpu", spec.reference_module("gnn"))
    sound = correctness.checks(correctness.judge(c, inp, cap), c.limits)
    control = correctness.checks(
        correctness.judge(c, inp, cap, as_program="control"), c.limits)
    assert correctness.passed(sound), sound
    assert not correctness.passed(control), control


def test_a_traced_run_on_the_cpu_reports_no_device_metric(files):
    last, _ = _run(files, "gcn_reddit.sampled", trace=1)
    assert last["metrics"] == {}
    assert "busy_s" not in last["device"] and "breakdown" not in last


@pytest.mark.cuda
def test_a_tiny_run_on_the_card_is_correct(files):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    bench_file, bench_dir = files
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(run.parse_args(["--workload", "gcn_reddit.fullgraph",
                                 "--seed", "5", "--seconds", "0.5",
                                 "--trace", "1"]),
                 run.Options(bench_file=bench_file, bench_dir=bench_dir,
                             graph_cache=bench_dir.parent / "graphs"),
                 out, err)
    assert rc == 0, err.getvalue()[-2000:]
    last = json.loads(out.getvalue().strip().splitlines()[-1])
    assert last["correct"], last["checks"]
    assert last["device"]["busy_s"] > 0


def test_a_run_whose_process_loaded_jax_prints_no_result(files, monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    bench_file, bench_dir = files
    out, err = io.StringIO(), io.StringIO()
    rc = run.run(run.parse_args(["--workload", "gcn_reddit.fullgraph",
                                 "--seed", "3", "--seconds", "0.2",
                                 "--trace", "0"]),
                 run.Options(bench_file=bench_file, bench_dir=bench_dir,
                             graph_cache=bench_dir.parent / "graphs",
                             device="cpu", require_chip=False), out, err)
    assert rc == 3 and '"correct"' not in out.getvalue()
    assert "jax" in err.getvalue()


def test_a_sampled_epochs_shapes_are_counted_outside_the_window(files):
    """A traced run counts its steps' shapes in the warm-up epoch: one
    entry a step, each layer's kept edges those of its blocks."""
    bench_file, bench_dir = files
    c = spec.load_cell("gcn_reddit.sampled", bench_file, bench_dir)
    arrays = graph.load_graph(c.config["graph"], bench_dir.parent / "graphs")
    trainer = program.build(c, 5, program.make_dataset(arrays, "tiny"),
                            "cpu")
    kept = []
    orig = trainer.sample

    def sample(seeds, valid, omit_map=None):
        batch = orig(seeds, valid, omit_map)
        kept.append([int((b.weight != 0).sum()) for b in batch.blocks])
        return batch

    trainer.sample = sample
    shapes = []
    with program.counting_shapes(trainer, shapes,
                                 c.reference.reads_own_rows(c.config)):
        edges = trainer.train_epoch()[-1]
    assert len(shapes) == len(kept) == len(trainer.step_losses)
    assert [[row[0] for row in step] for step in shapes] == kept
    assert sum(sum(k) for k in kept) == edges
