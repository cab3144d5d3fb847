"""The idle share is 1 - the union of device intervals over the window,
so overlapping streams are counted once and it cannot fall below 0; the
gaps are labelled by what the host was doing."""

from __future__ import annotations

from benchmark import trace
from benchmark.trace import Event, TraceData


def _dev(*spans):
    return [Event(f"k{i}", a, b) for i, (a, b) in enumerate(spans)]


def test_union_counts_overlapping_streams_once():
    ev = _dev((0, 10), (5, 15), (20, 30), (25, 26), (40, 60))
    assert trace.busy_ns(ev, (0, 100)) == 15 + 10 + 20
    assert trace.gaps(ev, (0, 100)) == [(15, 20), (30, 40), (60, 100)]


def test_window_clips_and_busy_never_exceeds_it():
    ev = _dev((-50, 10), (0, 200), (90, 300))
    assert trace.busy_ns(ev, (0, 100)) == 100
    assert trace.gaps(ev, (0, 100)) == []
    assert trace.busy_ns(_dev(), (0, 100)) == 0


def test_sum_of_self_times_would_exceed_the_window_but_union_does_not():
    # four streams each busy the whole window: 400% by summing
    ev = _dev(*[(0, 100)] * 4)
    assert sum(e.end - e.start for e in ev) == 400
    assert trace.busy_ns(ev, (0, 100)) == 100


def test_time_in_and_count_by_name():
    ev = [Event("gemm_a", 0, 10), Event("spmm_csr_kernel", 5, 20),
          Event("gemm_b", 30, 35)]
    assert trace.time_in(ev, (0, 100), lambda n: "gemm" in n) == 15
    assert trace.count(ev, (0, 100), lambda n: "gemm" in n) == 2
    assert trace.top_device_ops(ev, (0, 100))[0] == ["spmm_csr_kernel",
                                                     15e-9]


def test_idle_gaps_labelled_by_the_innermost_host_event():
    dev = _dev((0, 10), (50, 60), (90, 100))
    host = [Event("train_epoch", 0, 100, 1), Event("aten::item", 12, 48, 1),
            Event("cudaStreamSynchronize", 20, 45, 1),
            Event("aten::nonzero", 62, 88, 2)]
    t = TraceData(device=dev, host=host, window=(0, 100))
    got = dict(trace.idle_by_host(t))
    assert got == {"cudaStreamSynchronize": 40e-9, "aten::nonzero": 30e-9}


def test_no_host_event_is_named_as_such():
    t = TraceData(device=_dev((0, 10)), host=[], window=(0, 30))
    assert trace.idle_by_host(t) == [["host: no CUDA call", 20e-9]]
