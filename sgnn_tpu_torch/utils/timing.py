"""Per-phase wall-clock accumulators and the program's span recorder
(the port's copy of sgnn_tpu/utils/timing.py, with spans added).

Reference: get_time() deltas accumulated per phase all over the engines
(e.g. sample_time/transfer_feature_time/training_time,
toolkits/GCN_SAMPLE_PD_CACHE.hpp:120-147) and printed at end of run().
Same idea, as a reusable helper; `torch.cuda.synchronize` is the caller's
responsibility when timing device work.

Spans.  `span(name)` and `PhaseTimer.phase(name)` record a span into the
process-wide `RECORDER` while a `torch.profiler` session records
(`tracing()`: the profiler's own module flag, the one switch).  A span
holds its name, its parent (the innermost span open on its thread), its
step's identifier (epoch, step; inherited from the parent where not
given), its thread and its host start and end in ns on `time.time_ns()`,
the clock of the profiler's events.  A span given a CUDA `device` also
records a `torch.cuda.Event` pair on the current stream, resolved to
device milliseconds only when the spans are read (after the caller's
sync): it never syncs.  With no session, `span` returns one shared no-op
object after one flag read: no clock, no lock, no allocation.  Spans
opened with `always=True` (the trainer's build, the kernels' load, once a
process) are recorded whatever the switch says, the last KEPT_SPANS of
them; the others are kept until `RECORDER.clear()`, which
`utils.profiling.trace` calls as its session starts.  `RECORDER.counters`
(`utils.profiling.Counters`) holds the program's counts.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.autograd.profiler as _autograd_profiler

from .profiling import Counters

# spans recorded with no profiler session (`always=True`) that are kept
KEPT_SPANS = 64


class Timer:
    """Seconds on the host clock since construction or the last reset."""

    def __init__(self) -> None:
        self.t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def reset(self) -> float:
        """The seconds elapsed, restarting the count."""
        now = time.perf_counter()
        dt, self.t0 = now - self.t0, now
        return dt


class PhaseTimer:
    """Accumulate named phase durations: `with pt.phase("sample"): ...`.
    While tracing, each phase is also a span of the same name."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        # phases run on the prefetch thread too (train/trainer.py)
        self._lock = threading.Lock()

    def phase(self, name: str, epoch: Optional[int] = None,
              step: Optional[int] = None) -> "_Phase":
        return _Phase(self, name, epoch, step)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def summary(self) -> str:
        items = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return " | ".join(f"{k}={v:.4f}s(n={self.counts[k]})" for k, v in items)


class _Phase:
    __slots__ = ("timers", "name", "epoch", "step", "t0", "span")

    def __init__(self, timers: PhaseTimer, name: str, epoch, step) -> None:
        self.timers, self.name, self.epoch, self.step = (timers, name, epoch,
                                                         step)

    def __enter__(self) -> "_Phase":
        self.span = span(self.name, epoch=self.epoch, step=self.step)
        self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.timers.add(self.name, time.perf_counter() - self.t0)
        self.span.__exit__(*exc)
        return False


# ------------------------------------------------------------------ spans
def tracing() -> bool:
    """True while a `torch.profiler` session records."""
    return _autograd_profiler._is_profiler_enabled


class _NoSpan:
    """What `span` returns with tracing off: one shared object."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One span being recorded; the record itself once closed."""

    __slots__ = ("recorder", "id", "name", "parent", "epoch", "step",
                 "thread", "start_ns", "end_ns", "events", "traced")

    def __init__(self, recorder: "SpanRecorder", name: str, events,
                 epoch: Optional[int], step: Optional[int],
                 traced: bool) -> None:
        self.recorder, self.id, self.name = recorder, next(recorder._ids), name
        self.parent, self.epoch, self.step = None, epoch, step
        self.thread = threading.get_ident()
        self.start_ns = self.end_ns = None
        self.events, self.traced = events, traced

    def __enter__(self) -> "_Span":
        stack = self.recorder._stack()
        if stack:
            top = stack[-1]
            self.parent = top.id
            if self.epoch is None:
                self.epoch = top.epoch
            if self.step is None:
                self.step = top.step
        stack.append(self)
        self.start_ns = time.time_ns()
        if self.events is not None:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record()
        self.end_ns = time.time_ns()
        self.recorder._stack().pop()
        self.recorder._close(self)
        return False

    def device_ms(self) -> Optional[float]:
        """Device milliseconds between the span's events, None without
        them or before the device has passed the second."""
        if self.events is None or not self.events[1].query():
            return None
        return self.events[0].elapsed_time(self.events[1])

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "epoch": self.epoch, "step": self.step,
                "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device": self.events is not None,
                "device_ms": self.device_ms()}


class SpanRecorder:
    """Spans and counters of one process (the module's `RECORDER`)."""

    def __init__(self) -> None:
        self.counters = Counters()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)   # next() on it is atomic
        self._traced: List[_Span] = []
        self._kept: collections.deque = collections.deque(maxlen=KEPT_SPANS)

    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def open(self, name: str, device=None,
             epoch: Optional[int] = None, step: Optional[int] = None,
             traced: bool = True) -> _Span:
        """A span to enter; `device` as `span`'s."""
        if isinstance(device, torch.Tensor):
            device = device.device
        events = None
        if device is not None and device.type == "cuda":
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        return _Span(self, name, events, epoch, step, traced)

    def _close(self, s: _Span) -> None:
        with self._lock:
            (self._traced if s.traced else self._kept).append(s)

    def records(self) -> List[dict]:
        """Every closed span kept, by start, as dicts: `id`, `name`,
        `parent` (an id or None), `epoch`, `step`, `thread`, `start_ns`,
        `end_ns`, `device` (stamped) and `device_ms` (None where not
        stamped or not yet passed on the device).  Sync the device first
        for every device time."""
        with self._lock:
            spans = list(self._kept) + list(self._traced)
        return [s.as_dict() for s in sorted(spans, key=lambda s: s.start_ns)]

    def totals(self) -> Dict[str, tuple]:
        """Host seconds and count of the kept spans by name."""
        out: Dict[str, list] = collections.defaultdict(lambda: [0.0, 0])
        for r in self.records():
            out[r["name"]][0] += (r["end_ns"] - r["start_ns"]) / 1e9
            out[r["name"]][1] += 1
        return {k: tuple(v) for k, v in out.items()}

    def export(self) -> dict:
        """The spans (`records()`) and the counters, JSON-ready."""
        return {"clock": "time.time_ns", "spans": self.records(),
                "counters": self.counters.as_dict()}

    def clear(self) -> None:
        """Drop the spans recorded under a profiler session; the
        always-recorded ones and the counters stay."""
        with self._lock:
            self._traced.clear()


RECORDER = SpanRecorder()


def span(name: str, device=None, epoch: Optional[int] = None,
         step: Optional[int] = None, always: bool = False):
    """A context manager recording one span into `RECORDER` while tracing
    (or `always`); `device`, a CUDA device or a tensor on one, stamps it
    with events on the current stream."""
    if not (always or _autograd_profiler._is_profiler_enabled):
        return _NO_SPAN
    return RECORDER.open(name, device, epoch, step, traced=not always)


def cuda_graph_ms(fn: Callable[[], object], reps: int,
                  counters: Sequence[Callable] = ()) -> float:
    """Device milliseconds per call of `fn` on the current CUDA device: one
    warm-up call on a side stream, then `reps` calls captured into one CUDA
    graph, replayed once to warm it and once between CUDA events; the
    elapsed time over `reps`.  The host's launch cost is out of the
    reading, so a kernel of a few microseconds is timed and not its Python
    wrapper.  Raises without a card: there is no host-clock stand-in.

    `counters` are kernel wrappers with a `.launches` count.  A captured
    call counts a launch that only the replays run, and each replay runs
    it again, so each is raised by its captured launches once more: the
    counts then match the kernel runs (1 + 2·reps for one launch a call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_graph_ms: no CUDA device is visible")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = [f.launches for f in counters]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    captured = [f.launches - b for f, b in zip(counters, before)]
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    for f, n in zip(counters, captured):
        f.launches += n
    return start.elapsed_time(end) / reps
