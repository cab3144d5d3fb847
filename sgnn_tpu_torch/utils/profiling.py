"""Profiling and observability on torch (the port's counterpart of
sgnn_tpu/utils/profiling.py).

  - `trace(log_dir)` — `torch.profiler` around a code region, written as a
    Chrome trace (`trace.json`, open in chrome://tracing or Perfetto),
    with the program's spans beside it (`spans.json`,
    `utils.timing.RECORDER`); CUDA activity is recorded when a card is
    visible,
  - `memory_budget` — the device-memory budget the residency decisions
    use (`train/device_trainer.feature_capacity`,
    `train/inference.layerwise_inference`),
  - `device_memory_stats` — the card's memory in the JAX package's keys
    (`cache/feature_cache.hbm_feature_capacity`), and `log_memory`, one
    log line of what this process holds on the card,
  - `Counters` — named monotonic counters with a one-line summary
    (reference Cuda_Stream::total_*): the span recorder's counter store.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
from typing import Dict, Iterator, Optional

import torch

from .logging import get_logger

log = get_logger("sgnn.prof")

# the budget on the CPU, where no allocator reports free memory: the JAX
# package's figure for a backend without memory statistics
CPU_BUDGET_BYTES = 1 << 30


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record the region with `torch.profiler` (CPU, and CUDA when a card
    is visible) and write `log_dir/trace.json`, and beside it
    `log_dir/spans.json`: the program's spans of the session on the
    trace's clock with their device milliseconds, and its counters
    (`utils.timing.RECORDER`); the spans' totals are logged."""
    from .timing import RECORDER

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    RECORDER.clear()
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()   # the spans' events have passed
        with open(os.path.join(log_dir, "spans.json"), "w") as f:
            json.dump(RECORDER.export(), f)
        totals = sorted(RECORDER.totals().items(), key=lambda kv: -kv[1][0])
        log.info("spans: %s", " | ".join(f"{k}={s:.4f}s(n={n})"
                                         for k, (s, n) in totals))
def device_memory_stats(device: torch.device) -> Optional[dict]:
    """`{"bytes_limit", "bytes_in_use"}` of a CUDA device, from
    `torch.cuda.mem_get_info` (in use = total − free: this process's
    tensors, its allocator's cache and any other process's); None on the
    CPU, which has no such statistics."""
    if device.type != "cuda":
        return None
    free, total = torch.cuda.mem_get_info(device)
    return {"bytes_limit": int(total), "bytes_in_use": int(total - free)}


def memory_budget(device: torch.device,
                  budget_bytes: Optional[int] = None) -> int:
    """Bytes a resident structure may take: `budget_bytes` when given
    (HBM_BUDGET), else half the card's free memory (the rest is left to
    activations and the graph), or CPU_BUDGET_BYTES on the CPU."""
    if budget_bytes is not None:
        return int(budget_bytes)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return free // 2
    return CPU_BUDGET_BYTES


def log_memory(prefix: str = "", device=None) -> None:
    """Log this process's bytes on the card (`torch.cuda.memory_stats`:
    allocated now, at the peak, and reserved by the caching allocator)
    beside the card's total.  `device=None` means CUDA and raises without
    a card, as every entry point does; the CPU has nothing to log."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return
    stats = torch.cuda.memory_stats(dev)
    gib = float(1 << 30)
    _, total = torch.cuda.mem_get_info(dev)
    log.info("%scard memory: %.3f GiB allocated (peak %.3f), %.3f GiB "
             "reserved, of %.3f GiB", prefix,
             stats.get("allocated_bytes.all.current", 0) / gib,
             stats.get("allocated_bytes.all.peak", 0) / gib,
             stats.get("reserved_bytes.all.current", 0) / gib, total / gib)


class Counters:
    """Named monotonic counters (reference Cuda_Stream::total_* parity);
    `utils.timing.RECORDER.counters` is the program's."""

    def __init__(self) -> None:
        self._c: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, value: int = 1) -> None:
        with self._lock:
            self._c[name] += int(value)

    def get(self, name: str) -> int:
        return self._c[name]

    def ratio(self, num: str, den: str) -> float:
        d = self._c[den]
        return self._c[num] / d if d else 0.0

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._c)

    def summary(self) -> str:
        return " | ".join(f"{k}={v}" for k, v in sorted(self.as_dict().items()))
