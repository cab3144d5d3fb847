"""The port's span recorder (utils/timing.py) on the CPU.

With no profiler session the training loop records no span (only the
trainer's build and the kernels' load are recorded at all times), reads
no `time.time_ns` and creates no CUDA event.  Under `torch.profiler` one
device-sampled epoch records, for every step, device_epoch > {seeds,
device_step > {sample, train_step > {forward, backward, update}}} with
parent links and step identifiers, and a whole-graph epoch its six
spans; the spans are on the clock of the profiler's events; tracing
changes no loss and no parameter; the report's phase keys stay; the
CLI's `--profile DIR` writes the spans beside the trace.
"""

import dataclasses
import json
import os
import types
from collections import defaultdict

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sgnn_tpu_torch.__main__ import main
from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.synthetic import random_graph_dataset
from sgnn_tpu_torch.train import build_trainer
from sgnn_tpu_torch.train.device_trainer import DeviceSampleTrainer
from sgnn_tpu_torch.train.fullbatch import FullBatchTrainer
from sgnn_tpu_torch.utils import timing
from sgnn_tpu_torch.utils.logging import get_logger
from sgnn_tpu_torch.utils.profiling import Counters

DATA = os.path.join(os.path.dirname(__file__), "..", "data")

CFG = RunConfig(algorithm="GATSAMPLEALLGPU", layer_sizes=[16, 8, 4],
                fanout=[5, 3], batch_size=128, epochs=1, heads=2,
                vertices=600, drop_rate=0.5)
STEP_SPANS = {"seeds", "device_step", "sample", "train_step", "forward",
              "backward", "update"}
FULL_SPANS = ["epoch", "forward", "backward", "clean_forward", "update",
              "readback"]


@pytest.fixture(scope="module")
def ds():
    return random_graph_dataset(600, 8, 16, 4, seed=0)


@pytest.fixture
def recorder(monkeypatch):
    """A fresh process recorder for the test."""
    rec = timing.SpanRecorder()
    monkeypatch.setattr(timing, "RECORDER", rec)
    return rec


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _names(rec):
    return [r["name"] for r in rec.records()]


@pytest.mark.parametrize("algorithm", ["GATSAMPLEALLGPU", "GCNFULLBATCH"])
def test_no_session_records_only_the_build(ds, recorder, monkeypatch,
                                           algorithm):
    trainer = build_trainer(dataclasses.replace(CFG, algorithm=algorithm),
                            ds, device="cpu")
    assert _names(recorder) == ["build"]
    calls = defaultdict(int)

    def no_time_ns():
        calls["time_ns"] += 1
        return 0

    def event(*a, **k):
        calls["event"] += 1
        raise AssertionError("a CUDA event with tracing off")

    monkeypatch.setattr(timing, "time", types.SimpleNamespace(
        perf_counter=timing.time.perf_counter, time_ns=no_time_ns))
    monkeypatch.setattr(torch.cuda, "Event", event)
    assert not timing.tracing()
    trainer.train_epoch()
    assert calls == {}
    assert _names(recorder) == ["build"]
    # the off path hands out one shared object
    assert timing.span("x") is timing.span("y", torch.device("cpu"), 1, 2)


def test_kernel_load_is_recorded_with_its_counters(recorder, monkeypatch):
    from sgnn_tpu_torch.ops.cuda import build as kbuild

    monkeypatch.setattr(kbuild, "_built", {})
    monkeypatch.setattr(kbuild, "_lib_path",
                        lambda n: kbuild.BUILD_DIR / "none.so")
    monkeypatch.setattr(kbuild.Path, "exists", lambda self: True)
    monkeypatch.setattr(kbuild.ctypes, "CDLL", lambda path: object())
    kbuild.build_all(["spmm", "gat"])
    kbuild.build_all(["spmm"])          # loaded already: no span
    assert _names(recorder) == ["kernels.load"]
    assert recorder.counters.as_dict() == {"kernels.built": 0,
                                           "kernels.loaded": 2}
    assert isinstance(recorder.counters, Counters)


def test_sampled_epoch_records_the_step_tree(ds, recorder):
    trainer = build_trainer(CFG, ds, device="cpu")
    assert isinstance(trainer, DeviceSampleTrainer)
    trainer.train_epoch()
    _, prof = _traced(trainer.train_epoch)
    recs = [r for r in recorder.records() if r["name"] != "build"]
    by_id = {r["id"]: r for r in recs}
    epochs = [r for r in recs if r["name"] == "device_epoch"]
    assert len(epochs) == 1 and epochs[0]["parent"] is None
    ep = epochs[0]
    assert ep["epoch"] == 1     # the trainer's second epoch
    steps = -(-len(trainer.train_nids) // CFG.batch_size)
    assert steps >= 2

    def parent_name(r):
        return by_id[r["parent"]]["name"]

    per_step = defaultdict(dict)
    for r in recs:
        assert r["epoch"] == ep["epoch"]
        assert ep["start_ns"] <= r["start_ns"] <= r["end_ns"] <= ep["end_ns"]
        if r["name"] in STEP_SPANS:
            assert r["name"] not in per_step[r["step"]]
            per_step[r["step"]][r["name"]] = r
    assert sorted(per_step) == list(range(steps))
    for k, got in per_step.items():
        assert set(got) == STEP_SPANS, k
        assert parent_name(got["seeds"]) == "device_epoch"
        assert parent_name(got["device_step"]) == "device_epoch"
        assert parent_name(got["sample"]) == "device_step"
        assert parent_name(got["train_step"]) == "device_step"
        for child in ("forward", "backward", "update"):
            assert parent_name(got[child]) == "train_step"
        # the batch is pulled before its step opens
        assert got["seeds"]["end_ns"] <= got["device_step"]["start_ns"]
        assert (got["sample"]["end_ns"] <= got["train_step"]["start_ns"])
        assert (got["forward"]["end_ns"] <= got["backward"]["start_ns"]
                <= got["backward"]["end_ns"] <= got["update"]["start_ns"])
        for name in ("sample", "forward", "backward", "update"):
            assert got[name]["device"] is False     # no card: no events
    sync = [r for r in recs if r["name"] == "epoch_sync"]
    assert len(sync) == 1 and parent_name(sync[0]) == "device_epoch"
    assert len(recs) == 2 + len(STEP_SPANS) * steps


def test_fullbatch_epoch_records_its_six_spans(ds, recorder):
    trainer = build_trainer(dataclasses.replace(CFG,
                                                algorithm="GATFULLBATCH"),
                            ds, device="cpu")
    _traced(trainer.train_epoch)
    recs = [r for r in recorder.records() if r["name"] != "build"]
    assert [r["name"] for r in recs] == FULL_SPANS
    top = recs[0]
    assert top["parent"] is None and top["epoch"] == 0
    assert all(r["parent"] == top["id"] and r["epoch"] == 0
               for r in recs[1:])
    assert all(top["start_ns"] <= r["start_ns"] <= r["end_ns"]
               <= top["end_ns"] for r in recs[1:])
    # the trainer's own timers are the report's, with no phase added
    assert isinstance(trainer.base, FullBatchTrainer)
    report = trainer.run(1)
    assert report.timers is trainer.base.timers
    assert report.timers.totals == {}


def test_spans_are_on_the_profilers_clock(ds, recorder):
    """No aten op straddles a span's bounds, and the model's products lie
    in `forward` or `backward`: the recorder's clock is the trace's."""
    trainer = build_trainer(CFG, ds, device="cpu")
    _, prof = _traced(trainer.train_epoch)
    recs = [r for r in recorder.records() if r["name"] != "build"]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert ops
    inside = defaultdict(int)
    for e in ops:
        a = e.start_ns()
        b = a + e.duration_ns()
        for r in recs:
            if a < r["end_ns"] and b > r["start_ns"]:
                assert r["start_ns"] <= a and b <= r["end_ns"], (e.name(), r)
                inside[r["name"]] += 1
    for name in ("forward", "backward", "update", "sample", "seeds"):
        assert inside[name] > 0, name
    mm = [e for e in ops if e.name() in ("aten::mm", "aten::bmm",
                                         "aten::matmul")]
    assert mm
    model = [r for r in recs if r["name"] in ("forward", "backward")]
    for e in mm:
        assert any(r["start_ns"] <= e.start_ns() < r["end_ns"]
                   for r in model)


@pytest.mark.parametrize("algorithm", ["GATSAMPLEALLGPU", "GATFULLBATCH"])
def test_tracing_changes_no_number(ds, recorder, algorithm):
    cfg = dataclasses.replace(CFG, algorithm=algorithm)
    if algorithm == "GATSAMPLEALLGPU":
        # two steps an epoch
        cfg = dataclasses.replace(cfg, batch_size=pad_batch(ds))
    runs = []
    for traced in (False, True):
        trainer = build_trainer(cfg, ds, device="cpu")
        losses = []
        for _ in range(2 if algorithm == "GATFULLBATCH" else 1):
            step = (_traced(trainer.train_epoch)[0] if traced
                    else trainer.train_epoch())
            losses.append(step[0])
        core = getattr(trainer, "base", trainer)
        runs.append((losses, getattr(core, "step_losses", None),
                     [p.detach().clone() for p in core.params.leaves()]))
    (l0, s0, p0), (l1, s1, p1) = runs
    assert l0 == l1 and s0 == s1
    if s0 is not None:
        assert len(s0) == 2
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def pad_batch(ds):
    from sgnn_tpu_torch.data.dataset import MASK_TRAIN

    n = len(ds.nids_with_mask(MASK_TRAIN))
    return -(-n // 2)


@pytest.mark.parametrize("algorithm,keys", [
    ("GATSAMPLEALLGPU", {"device_step", "device_eval"}),
    ("GCNSAMPLEGPU", {"sample", "transfer", "train_step", "eval_step"}),
    ("GCNFULLBATCH", set()),
])
def test_phase_totals_keys_unchanged_by_tracing(ds, recorder, algorithm,
                                                keys):
    cfg = dataclasses.replace(CFG, algorithm=algorithm)
    for traced in (False, True):
        trainer = build_trainer(cfg, ds, device="cpu")
        run = lambda: trainer.run(1)        # noqa: E731
        report = _traced(run)[0] if traced else run()
        assert set(report.to_dict()["phase_totals_s"]) == keys


def test_span_records_and_device_times_when_read(recorder):
    """Children inherit the step identifier; records are by start; a span
    with no events has no device time; clear() keeps the build spans."""
    with timing.span("b", always=True):
        pass
    _, _prof = _traced(lambda: _nest())
    names = _names(recorder)
    assert names == ["b", "outer", "inner", "own"]
    r = {x["name"]: x for x in recorder.records()}
    assert (r["inner"]["epoch"], r["inner"]["step"]) == (3, 4)
    assert (r["own"]["epoch"], r["own"]["step"]) == (3, 9)
    assert r["inner"]["parent"] == r["outer"]["id"]
    assert r["outer"]["device_ms"] is None
    assert recorder.totals()["inner"][1] == 1
    recorder.clear()
    assert _names(recorder) == ["b"]
    out = recorder.export()
    assert out["clock"] == "time.time_ns" and out["spans"][0]["name"] == "b"


def _nest():
    with timing.span("outer", epoch=3, step=4):
        with timing.span("inner"):
            pass
        with timing.span("own", step=9):
            pass


def test_phase_totals_and_span_of_a_phase(recorder):
    pt = timing.PhaseTimer()
    with pt.phase("p"):
        pass
    assert _names(recorder) == [] and pt.counts["p"] == 1
    _traced(lambda: pt.phase("p", 0, 1).__enter__().__exit__(None, None,
                                                             None))
    assert pt.counts["p"] == 2
    (rec,) = recorder.records()
    assert (rec["name"], rec["epoch"], rec["step"]) == ("p", 0, 1)


def test_cli_profile_writes_spans_beside_the_trace(tmp_path, recorder,
                                                   caplog):
    cfg = tmp_path / "cli.cfg"
    cfg.write_text("\n".join([
        "ALGORITHM:GSSAMPLEALLGPU", "VERTICES:2708", "LAYERS:1433-16-7",
        "FANOUT:5-3", "BATCH_SIZE:512", "EPOCHS:1",
        f"EDGE_FILE:{DATA}/cora.2708.edge.self",
        f"FEATURE_FILE:{DATA}/cora.featuretable",
        f"LABEL_FILE:{DATA}/cora.labeltable",
        f"MASK_FILE:{DATA}/cora.mask"]) + "\n")
    out = tmp_path / "prof"
    log = get_logger("sgnn.prof")   # its own handler, no propagation
    log.addHandler(caplog.handler)
    try:
        assert main([str(cfg), "--cpu", "--profile", str(out)]) == 0
    finally:
        log.removeHandler(caplog.handler)
    assert (out / "trace.json").stat().st_size > 0
    rec = json.loads((out / "spans.json").read_text())
    names = {s["name"] for s in rec["spans"]}
    assert {"build", "device_epoch", "device_step", "seeds", "sample",
            "train_step", "forward", "backward", "update",
            "epoch_sync"} <= names
    assert rec["clock"] == "time.time_ns" and "counters" in rec
    assert any(r.getMessage().startswith("spans: ") and "device_step=" in
               r.getMessage() for r in caplog.records)
