"""The readers of the program's spans on synthetic spans and gaps: each
idle gap goes to the innermost span open at its middle on the launching
thread, the classes add up to the device's idle share, the device times
are per step, and nothing is read where no span was recorded."""

from __future__ import annotations

import types

import pytest

from benchmark import readings, spans, spec
from benchmark.tests import tiny
from benchmark.trace import Event, TraceData

WHOLE = None
MAIN, OTHER = 11, 22


@pytest.fixture(scope="module", autouse=True)
def _whole(tmp_path_factory):
    global WHOLE
    WHOLE = tiny.whole(tmp_path_factory.mktemp("whole"))


def _span(i, name, a, b, parent=None, thread=MAIN, step=None, ms=None):
    return {"id": i, "name": name, "parent": parent, "epoch": 0,
            "step": step, "thread": thread, "start_ns": a, "end_ns": b,
            "device": ms is not None, "device_ms": ms}


# one epoch of two steps on the launching thread, in ns:
#   device_epoch [0, 1000)
#     seeds [0, 40) step 0, device_step [40, 500) step 0
#       sample [50, 200), train_step [200, 480) > forward [210, 300),
#       backward [300, 420), update [420, 470)
#     seeds [500, 540) step 1, device_step [540, 950) step 1
#       sample [550, 700) ms 0.5, train_step [700, 940) > forward ...
#     epoch_sync [950, 1000)
# and a span of another thread over [0, 1000) that owns nothing
SPANS = [
    _span(1, "device_epoch", 0, 1000),
    _span(2, "seeds", 0, 40, 1, step=0),
    _span(3, "device_step", 40, 500, 1, step=0),
    _span(4, "sample", 50, 200, 3, step=0, ms=0.25),
    _span(5, "train_step", 200, 480, 3, step=0),
    _span(6, "forward", 210, 300, 5, step=0, ms=1.0),
    _span(7, "backward", 300, 420, 5, step=0, ms=2.0),
    _span(8, "update", 420, 470, 5, step=0, ms=0.5),
    _span(9, "seeds", 500, 540, 1, step=1),
    _span(10, "device_step", 540, 950, 1, step=1),
    _span(11, "sample", 550, 700, 10, step=1, ms=0.75),
    _span(12, "train_step", 700, 940, 10, step=1),
    _span(13, "forward", 710, 800, 12, step=1, ms=3.0),
    _span(14, "backward", 800, 900, 12, step=1, ms=4.0),
    _span(15, "epoch_sync", 950, 1000, 1),
    _span(16, "prefetch", 0, 1000, thread=OTHER),
]
# device busy everywhere but these gaps (middles in brackets):
#   [20, 60) (40: device_step 0) -> loop; [100, 140) (120: sample) ->
#   sampler; [250, 270) (260: forward) -> step; [430, 450) (440: update)
#   -> step; [505, 535) (520: seeds) -> loop; [1000, 1200) (1100: none)
#   -> uncovered
GAPS = [(20, 60), (100, 140), (250, 270), (430, 450), (505, 535)]
WINDOW = (0, 1200)


def _device():
    ev, cur = [], WINDOW[0]
    for a, b in GAPS:
        ev.append(Event("k", cur, a))
        cur = b
    ev.append(Event("k", cur, 1000))
    return ev


def _ctx(cell_name, device=None, window=WINDOW, build_end=None):
    cell = spec.load_cell(cell_name, WHOLE)
    win = types.SimpleNamespace(
        seconds=(window[1] - window[0]) / 1e9, span_ns=window,
        epochs=[types.SimpleNamespace(steps=2, step_ms=[], edges=0,
                                      loss=1.0)])
    return readings.Context(cell=cell, setup_s=1.0, window=win,
                            device_name="NVIDIA H100 80GB HBM3",
                            num_vertices=600, num_edges=4800,
                            trace=TraceData(device if device is not None
                                            else _device(), [], window))


@pytest.fixture
def recorded(monkeypatch):
    def use(records):
        monkeypatch.setattr(spans, "recorded", lambda: records)
    return use


def test_each_gap_goes_to_the_innermost_span_at_its_middle():
    mine = [s for s in SPANS if s["thread"] == MAIN]
    got = spans.innermost_at(mine, [40, 120, 260, 440, 520, 1100])
    assert [s["name"] if s else None for s in got] == [
        "device_step", "sample", "forward", "update", "seeds", None]


def test_the_launching_thread_is_the_one_with_most_spans():
    assert spans.launching_thread(SPANS) == MAIN
    assert spans.launching_thread([]) is None


def test_classes_add_up_to_the_idle_time():
    ns = spans.idle_by_class(SPANS, _device(), WINDOW,
                             spans.SAMPLED_CLASSES)
    assert ns == {"loop": 40 + 30, "sampler": 40, "step": 20 + 20,
                  "uncovered": 200}
    assert sum(ns.values()) == WINDOW[1] - WINDOW[0] - sum(
        b - a for a, b in spans.trace.union(
            (e.start, e.end) for e in _device()))


def test_idle_readers_sum_to_the_device_idle_share(recorded):
    recorded(SPANS)
    ctx = _ctx("gat_reddit.sampled")
    parts = {c: spans.idle_pct(ctx, "sampled", c)
             for c in ("sampler", "step", "loop", "uncovered")}
    assert parts["sampler"] == pytest.approx(100 * 40 / 1200)
    assert parts["step"] == pytest.approx(100 * 40 / 1200)
    assert parts["loop"] == pytest.approx(100 * 70 / 1200)
    assert sum(parts.values()) == pytest.approx(
        readings.idle_pct(ctx, "sampled"))
    for name, cls in (("sampler.idle_pct.sampled", "sampler"),
                      ("step.idle_pct.sampled", "step"),
                      ("loop.idle_pct.sampled", "loop")):
        assert spec.metric_reader(name).read(ctx) == parts[cls]


def test_whole_graph_epochs_cover_their_idle(recorded):
    fg = [_span(1, "epoch", 0, 1000), _span(2, "forward", 10, 400, 1),
          _span(3, "readback", 900, 1000, 1)]
    recorded(fg)
    ctx = _ctx("gcn_reddit.fullgraph")
    assert spans.idle_pct(ctx, "fullgraph", "epoch") == pytest.approx(
        100 * sum(b - a for a, b in GAPS) / 1200)
    # the sampled readers read nothing in a whole-graph cell
    assert spec.metric_reader("sampler.idle_pct.sampled").read(ctx) is None


def test_device_times_are_per_step(recorded):
    recorded(SPANS)
    ctx = _ctx("gat_reddit.sampled")
    assert spec.metric_reader("sampler.ms_per_step.sampled").read(
        ctx) == pytest.approx((0.25 + 0.75) / 2)
    assert spec.metric_reader("model.ms_per_step.sampled").read(
        ctx) == pytest.approx((1.0 + 2.0 + 3.0 + 4.0) / 2)


def test_spans_outside_the_window_are_not_read(recorded):
    recorded(SPANS)
    ctx = _ctx("gat_reddit.sampled", window=(2000, 3000),
               device=[Event("k", 2000, 2500)])
    for name in ("sampler.ms_per_step.sampled", "model.ms_per_step.sampled",
                 "sampler.idle_pct.sampled", "step.idle_pct.sampled",
                 "loop.idle_pct.sampled"):
        assert spec.metric_reader(name).read(ctx) is None, name


@pytest.mark.parametrize("records", [None, []])
def test_nothing_is_read_without_spans(recorded, records):
    recorded(records)
    ctx = _ctx("gat_reddit.sampled")
    for name in ("sampler.ms_per_step.sampled", "model.ms_per_step.sampled",
                 "sampler.idle_pct.sampled", "step.idle_pct.sampled",
                 "loop.idle_pct.sampled", "setup.build_s"):
        assert spec.metric_reader(name).read(ctx) is None, name


def test_nothing_is_read_without_device_events(recorded):
    recorded(SPANS)
    ctx = _ctx("gat_reddit.sampled", device=[])
    assert spec.metric_reader("sampler.idle_pct.sampled").read(ctx) is None


def test_build_is_the_last_build_before_the_window(recorded):
    recorded([_span(1, "build", 100, 400), _span(2, "kernels.load", 5, 9),
              _span(3, "build", 1000, 3500), _span(4, "build", 5000, 6000)])
    ctx = _ctx("gcn_reddit.fullgraph", window=(4000, 7000),
               device=[Event("k", 4000, 5000)])
    assert spec.metric_reader("setup.build_s").read(ctx) == pytest.approx(
        2500 / 1e9)


def test_the_recorder_of_the_program_is_read():
    from sgnn_tpu_torch.utils import timing

    got = spans.recorded()
    assert got == timing.RECORDER.records()
