"""Per-phase wall-clock accumulators (the port's copy of
sgnn_tpu/utils/timing.py).

Reference: get_time() deltas accumulated per phase all over the engines
(e.g. sample_time/transfer_feature_time/training_time,
toolkits/GCN_SAMPLE_PD_CACHE.hpp:120-147) and printed at end of run().
Same idea, as a reusable helper; `torch.cuda.synchronize` is the caller's
responsibility when timing device work.
"""

from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Sequence

import torch


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
    """Accumulate named phase durations: `with pt.phase("sample"): ...`."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        # phases run on the prefetch thread too (train/trainer.py)
        self._lock = threading.Lock()

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def summary(self) -> str:
        items = sorted(self.totals.items(), key=lambda kv: -kv[1])
        return " | ".join(f"{k}={v:.4f}s(n={self.counts[k]})" for k, v in items)


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
