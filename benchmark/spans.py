"""The program's own spans (`sgnn_tpu_torch.utils.timing.RECORDER`) as
the per-layer readers see them: clipped to the traced window, their
device times, and the card's idle gaps attributed to them.

The program records a span while a `torch.profiler` session records, on
the clock of the profiler's events (`time.time_ns()`), which the window's
bounds are taken on too.  Each idle gap of the window
(`trace.gaps(device events, window)`) goes to the innermost span open at
the gap's middle on the launching thread (the thread that recorded the
most spans in the window), as `trace.host_at` labels a gap by the host's
CUDA call.  The idle no span covers is kept apart, so the classes add up
to the device's idle share.

A program older than its spans has no recorder: every reader then finds
nothing and returns None.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace

Interval = Tuple[int, int]

# a sampled step's idle by the nearest enclosing span of these names:
# the sampler, the train step (forward, backward, update) and the loop
# around them (`seeds`, `device_step`, `epoch_sync`)
SAMPLED_CLASSES = {"sample": "sampler", "train_step": "step",
                   "device_epoch": "loop"}
# whole-graph epochs: any span of the epoch
FULLGRAPH_CLASSES = {"epoch": "epoch"}
UNCOVERED = "uncovered"


def recorded() -> Optional[List[dict]]:
    """Every span the program kept (`SpanRecorder.records()`), or None
    where the program has no recorder."""
    try:
        from sgnn_tpu_torch.utils import timing
    except ImportError:
        return None
    rec = getattr(timing, "RECORDER", None)
    return rec.records() if rec is not None else None


def in_window(spans: Sequence[dict], window: Interval) -> List[dict]:
    lo, hi = window
    return [s for s in spans if s["end_ns"] > lo and s["start_ns"] < hi]


def launching_thread(spans: Sequence[dict]) -> Optional[int]:
    counts = Counter(s["thread"] for s in spans)
    return counts.most_common(1)[0][0] if counts else None


def innermost_at(spans: Sequence[dict], points: Sequence[int]
                 ) -> List[Optional[dict]]:
    """For each point (ascending), the innermost of `spans` (one thread's,
    properly nested) open then: start <= point < end; None where none."""
    evs = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    out: List[Optional[dict]] = []
    stack: List[dict] = []
    i = 0
    for p in points:
        while i < len(evs) and evs[i]["start_ns"] <= p:
            while stack and stack[-1]["end_ns"] <= evs[i]["start_ns"]:
                stack.pop()
            stack.append(evs[i])
            i += 1
        while stack and stack[-1]["end_ns"] <= p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def classify(span: Optional[dict], by_id: Dict[int, dict],
             classes: Dict[str, str]) -> str:
    """The class of the nearest span, from `span` up its parents, whose
    name `classes` maps; UNCOVERED where none (or no span)."""
    while span is not None:
        if span["name"] in classes:
            return classes[span["name"]]
        span = by_id.get(span["parent"])
    return UNCOVERED


def idle_by_class(spans: Sequence[dict], device: Sequence[trace.Event],
                  window: Interval, classes: Dict[str, str]
                  ) -> Dict[str, int]:
    """Idle nanoseconds of the window by class; the values add up to the
    window's idle time."""
    spans = in_window(spans, window)
    thread = launching_thread(spans)
    mine = [s for s in spans if s["thread"] == thread]
    by_id = {s["id"]: s for s in spans}
    gaps = trace.gaps(device, window)
    owners = innermost_at(mine, [(a + b) // 2 for a, b in gaps])
    out: Dict[str, int] = defaultdict(int)
    for (a, b), s in zip(gaps, owners):
        out[classify(s, by_id, classes)] += b - a
    return dict(out)


def _traced_spans(ctx, mode: str) -> Optional[List[dict]]:
    if not ctx.traced_device or ctx.mode != mode:
        return None
    spans = recorded()
    if not spans:
        return None
    spans = in_window(spans, ctx.trace.window)
    return spans or None


def idle_pct(ctx, mode: str, cls: str) -> Optional[float]:
    """Percent of the traced window idle and attributed to `cls`."""
    spans = _traced_spans(ctx, mode)
    if spans is None:
        return None
    classes = SAMPLED_CLASSES if mode == "sampled" else FULLGRAPH_CLASSES
    ns = idle_by_class(spans, ctx.trace.device, ctx.trace.window, classes)
    lo, hi = ctx.trace.window
    return 100.0 * ns.get(cls, 0) / (hi - lo)


def device_ms_per_step(ctx, names: Sequence[str]) -> Optional[float]:
    """The mean over the window's steps of the device milliseconds of the
    spans called `names`, summed within a step (epoch, step)."""
    spans = _traced_spans(ctx, "sampled")
    if spans is None:
        return None
    per: Dict[tuple, float] = defaultdict(float)
    for s in spans:
        if s["name"] in names and s["device_ms"] is not None:
            per[(s["epoch"], s["step"])] += s["device_ms"]
    return sum(per.values()) / len(per) if per else None


def build_s(ctx) -> Optional[float]:
    """Seconds of the last `build` span that ended before the window."""
    spans = recorded()
    if not spans:
        return None
    opened = ctx.window.span_ns[0]
    builds = [s for s in spans if s["name"] == "build"
              and s["end_ns"] <= opened]
    if not builds:
        return None
    last = max(builds, key=lambda s: s["end_ns"])
    return (last["end_ns"] - last["start_ns"]) / 1e9
