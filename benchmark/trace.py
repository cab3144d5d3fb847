"""Reading the profiler's trace: device intervals, their union, the idle
gaps and what the host was doing in them.

The traced window records the card's activity and the host's CUDA calls
(`ProfilerActivity.CUDA`): recording every host operator as well slowed a
sampled step by two thirds on the card.  Device time is the union of the
intervals in which any kernel, copy or memset ran on the card, clipped to
the traced window, so overlapping streams are counted once and the busy
share cannot pass 100%.  The harness launches no kernel of its own in
the traced window.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[int, int]


@dataclasses.dataclass
class Event:
    name: str
    start: int      # ns, on the host's realtime clock (the trace's)
    end: int        # ns
    thread: int = 0


@dataclasses.dataclass
class TraceData:
    """What a traced window holds: device events, the host's CUDA calls,
    and the window's bounds on the trace's clock."""

    device: List[Event]
    host: List[Event]
    window: Interval


def _ns(e, what: str) -> int:
    f = getattr(e, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{what}_us")() * 1000)


def _is_annotation(e) -> bool:
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def from_profiler(prof, window: Interval) -> TraceData:
    """The device events and host CUDA calls of a finished
    `torch.profiler.profile` (Kineto's results), on the host's realtime
    clock (`time.time_ns()`), which `window` is taken on; annotations on
    either timeline are left out."""
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if _is_annotation(e):
            continue
        start = _ns(e, "start")
        dur = int(e.duration_ns()) if hasattr(e, "duration_ns") else int(
            e.duration_us() * 1000)
        ev = Event(e.name(), start, start + dur, int(e.start_thread_id()))
        (device if str(e.device_type()).endswith("CUDA") else host).append(ev)
    return TraceData(device=device, host=host, window=tuple(window))


def clip(intervals: Iterable[Interval], window: Interval) -> List[Interval]:
    lo, hi = window
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi and min(b, hi) > max(a, lo)]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint sorted intervals covering the same points."""
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_ns(events: Sequence[Event], window: Interval) -> int:
    """Nanoseconds of the window in which some device event ran."""
    return sum(b - a for a, b in union(clip(((e.start, e.end)
                                              for e in events), window)))


def gaps(events: Sequence[Event], window: Interval) -> List[Interval]:
    """The window's intervals in which no device event ran."""
    out, cur = [], window[0]
    for a, b in union(clip(((e.start, e.end) for e in events), window)):
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < window[1]:
        out.append((cur, window[1]))
    return out


def time_in(events: Sequence[Event], window: Interval,
            keep=lambda name: True) -> int:
    """Nanoseconds of the union of the device events whose name `keep`
    accepts, clipped to the window."""
    return busy_ns([e for e in events if keep(e.name)], window)


def count(events: Sequence[Event], window: Interval,
          keep=lambda name: True) -> int:
    lo, hi = window
    return sum(1 for e in events if keep(e.name) and lo <= e.start < hi)


def top_device_ops(events: Sequence[Event], window: Interval,
                   n: int = 10) -> List[list]:
    """The device operations with the most time in the window, by name:
    [[name, seconds], ...]."""
    tot: Dict[str, int] = defaultdict(int)
    for a, b, name in ((max(e.start, window[0]), min(e.end, window[1]),
                        e.name) for e in events):
        if b > a:
            tot[name[:120]] += b - a
    return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                            key=lambda kv: -kv[1])[:n]]


def host_at(host: Sequence[Event], points: Sequence[int]) -> List[str]:
    """For each point (ascending), the innermost host event running then,
    across threads the one that started last; "host: no CUDA call" where
    none was (the host was in Python or in CPU work)."""
    by_thread: Dict[int, List[Event]] = defaultdict(list)
    for e in host:
        by_thread[e.thread].append(e)
    per_thread = []
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e.start, -e.end))
        per_thread.append(evs)
    labels: List[Optional[Event]] = [None] * len(points)
    for evs in per_thread:
        stack: List[Event] = []
        i = 0
        for j, p in enumerate(points):
            while i < len(evs) and evs[i].start <= p:
                while stack and stack[-1].end <= evs[i].start:
                    stack.pop()
                stack.append(evs[i])
                i += 1
            while stack and stack[-1].end <= p:
                stack.pop()
            if stack and (labels[j] is None
                          or stack[-1].start > labels[j].start):
                labels[j] = stack[-1]
    return [e.name if e is not None else "host: no CUDA call"
            for e in labels]


def idle_by_host(trace: TraceData, n: int = 10) -> List[list]:
    """The window's idle time by what the host was doing at each gap's
    middle: [[label, seconds], ...], the n largest."""
    g = gaps(trace.device, trace.window)
    mids = [(a + b) // 2 for a, b in g]
    tot: Dict[str, int] = defaultdict(int)
    for (a, b), label in zip(g, host_at(trace.host, mids)):
        tot[label[:120]] += b - a
    return [[k, v / 1e9] for k, v in sorted(tot.items(),
                                            key=lambda kv: -kv[1])[:n]]


def launch_summary(trace: TraceData, n: int = 40) -> Dict[str, list]:
    """Launches and seconds of the window's device operations by name,
    the n with most time: a record beside the result, for finding which
    kernels a reader's patterns meet."""
    lo, hi = trace.window
    launches: Dict[str, int] = defaultdict(int)
    for e in trace.device:
        if lo <= e.start < hi:
            launches[e.name[:120]] += 1
    ops = top_device_ops(trace.device, trace.window, n)
    return {"window_ns": [lo, hi], "device_events": len(trace.device),
            "host_events": len(trace.host),
            "ops": [[k, v, launches.get(k, 0)] for k, v in ops]}
