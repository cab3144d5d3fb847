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
from typing import Dict


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
