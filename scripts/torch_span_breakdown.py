#!/usr/bin/env python3
"""One benchmark run with the card's idle broken down by the program's spans,
or the cost of one span site.

    python3 scripts/torch_span_breakdown.py --workload CELL --seed N
                                            --seconds 20 --trace 1
    python3 scripts/torch_span_breakdown.py --site-cost [--n 20000]

The first form runs `benchmark/run.py` of this checkout with the same
arguments and, when the run is traced on a card, prints one more line
before the result: `SPANS {...}`, the traced window's idle by span class
(`benchmark/spans.py`'s attribution, with the idle no span covers), by
innermost span, and its largest uncovered gaps with their distance to the
nearest spans; the kernel and graph launches in the window, how many
cross a span's bound and how many each `sample` span holds; each span's mean device
milliseconds and host seconds; Python's garbage collections in the window
and the idle they overlap; the `build` and `kernels.load` spans and the
counters.  The result line is the run's own.

`--site-cost` prints the host nanoseconds of one span site and of one
phase, with no profiler session and (on a card) inside one with CUDA
activity, as the traced window records, with and without a device stamp.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import sys
import time
from collections import Counter, defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

def _launch(name: str) -> bool:
    """A kernel launch or a CUDA graph launch (the sampler's replay)."""
    return "LaunchKernel" in name or "GraphLaunch" in name


# (start, end, generation) of every collection, on the trace's clock
GC_LOG: list = []
_gc_start = [0]


def _gc_callback(phase, info):
    if phase == "start":
        _gc_start[0] = time.time_ns()
    else:
        GC_LOG.append((_gc_start[0], time.time_ns(), info["generation"]))


def breakdown(ctx) -> dict:
    """What a traced window's spans show (see the module's docstring)."""
    from benchmark import spans, trace
    from sgnn_tpu_torch.utils import timing

    recs = spans.recorded() or []
    win = ctx.trace.window
    inw = spans.in_window(recs, win)
    if not inw:
        return {"spans": None}
    classes = (spans.SAMPLED_CLASSES if ctx.mode == "sampled"
               else spans.FULLGRAPH_CLASSES)
    by_class = spans.idle_by_class(inw, ctx.trace.device, win, classes)
    idle = sum(by_class.values())
    thread = spans.launching_thread(inw)
    mine = [s for s in inw if s["thread"] == thread]
    gaps = trace.gaps(ctx.trace.device, win)
    owners = spans.innermost_at(mine, [(a + b) // 2 for a, b in gaps])
    by_inner: dict = defaultdict(int)
    for (a, b), s in zip(gaps, owners):
        by_inner[s["name"] if s else "none"] += b - a
    ends = sorted(s["end_ns"] for s in mine)
    starts = sorted(s["start_ns"] for s in mine)
    uncovered = sorted(((a, b) for (a, b), s in zip(gaps, owners)
                        if s is None), key=lambda g: g[0] - g[1])[:8]
    largest = []
    for a, b in uncovered:
        mid = (a + b) // 2
        i = bisect.bisect_right(ends, mid) - 1
        j = bisect.bisect_right(starts, mid)
        largest.append({
            "len_us": (b - a) / 1e3,
            "after_last_span_us": (mid - ends[i]) / 1e3 if i >= 0 else None,
            "before_next_span_us": ((starts[j] - mid) / 1e3
                                    if j < len(starts) else None)})
    launches = sorted(e.start for e in ctx.trace.host
                      if _launch(e.name) and win[0] <= e.start < win[1])
    host_end = {e.start: e.end for e in ctx.trace.host if _launch(e.name)}
    bounds = sorted(b for s in mine for b in (s["start_ns"], s["end_ns"]))
    crossing = 0
    for t in launches:
        k = bisect.bisect_right(bounds, t)
        crossing += k < len(bounds) and bounds[k] < host_end[t]
    per_sample = [bisect.bisect_left(launches, s["end_ns"])
                  - bisect.bisect_left(launches, s["start_ns"])
                  for s in mine if s["name"] == "sample"]
    device_ms: dict = defaultdict(list)
    host_s: dict = defaultdict(float)
    for s in inw:
        host_s[s["name"]] += (s["end_ns"] - s["start_ns"]) / 1e9
        if s["device_ms"] is not None:
            device_ms[s["name"]].append(s["device_ms"])
    gcs = [c for c in GC_LOG if c[1] > win[0] and c[0] < win[1]]
    gc_idle = sum(max(0, min(b, e) - max(a, s0))
                  for a, b in gaps for s0, e, _ in gcs)
    return {
        "window_ns": win[1] - win[0], "idle_ns": idle,
        "idle_ns_by_class": by_class,
        "covered_share": 1 - by_class.get(spans.UNCOVERED, 0) / idle
        if idle else None,
        "idle_ns_by_innermost": dict(by_inner),
        "largest_uncovered_gaps": largest,
        "spans_in_window": dict(Counter(s["name"] for s in inw)),
        "launches_in_window": len(launches),
        "launches_crossing_a_span_bound": crossing,
        "launches_per_sample_min_max": ([min(per_sample), max(per_sample)]
                                        if per_sample else None),
        "device_ms_mean": {k: sum(v) / len(v) for k, v in device_ms.items()},
        "host_s_by_span": dict(host_s),
        "gc_in_window": len(gcs), "idle_in_gc_ns": gc_idle,
        "build_spans": [[s["name"], (s["end_ns"] - s["start_ns"]) / 1e9]
                        for s in recs if s["name"] in ("build",
                                                       "kernels.load")],
        "counters": timing.RECORDER.counters.as_dict()}


def site_cost(n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sgnn_tpu_torch.utils import timing

    cuda = torch.cuda.is_available()
    dev = torch.device("cuda" if cuda else "cpu")
    if cuda:
        torch.zeros(1, device=dev)
    pt = timing.PhaseTimer()

    def per(fn, reps):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) / reps * 1e9

    def empty():
        pass

    def site():
        with timing.span("x"):
            pass

    def site_dev():
        with timing.span("x", dev):
            pass

    def phase():
        with pt.phase("p", 1, 2):
            pass

    fns = {"empty": empty, "span": site, "span_device": site_dev,
           "phase": phase}
    out = {"device": torch.cuda.get_device_name(0) if cuda else "cpu",
           "off_ns": {k: per(f, n) for k, f in fns.items()}}
    if cuda:
        with profile(activities=[ProfilerActivity.CUDA]):
            out["on_ns"] = {k: per(f, n // 10) for k, f in fns.items()}
        torch.cuda.synchronize()
        timing.RECORDER.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--site-cost", action="store_true")
    ap.add_argument("--n", type=int, default=20000)
    args, rest = ap.parse_known_args(argv)
    if args.site_cost:
        print(json.dumps(site_cost(args.n)))
        return 0
    from benchmark import run, spec

    read = spec.read_metrics

    def read_metrics(metrics, ctx, bench_dir=spec.BENCH_DIR):
        if ctx.trace is not None and ctx.traced_device:
            print("SPANS " + json.dumps(breakdown(ctx)), flush=True)
        return read(metrics, ctx, bench_dir)

    spec.read_metrics = read_metrics
    gc.callbacks.append(_gc_callback)
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
