"""What a run hands to the metric readers (`metrics/<name>.py`), and the
arithmetic they share.

Every reader is `read(ctx) -> float | None`; None means it found nothing
to read (another mode's cell, an untraced run, kernels absent from the
trace or launched other than the cell's structure predicts), and the
metric is then left out of the result line.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from . import bounds, kernel_names, trace
from .peaks import flops_peak


@dataclasses.dataclass
class Context:
    cell: object                 # spec.Cell
    setup_s: float
    window: object               # program.Window (the measured window)
    device_name: str
    num_vertices: int
    num_edges: int
    trace: Optional[trace.TraceData] = None
    # sampled traced runs: per step of the untraced warm-up epoch before
    # the window, per layer (nnz, dv, sv, D, K, S); every epoch covers the
    # training vertices once in batches of the same sizes, and the window
    # holds whole epochs
    shapes: Optional[List[List[tuple]]] = None

    @property
    def mode(self) -> str:
        return self.cell.mode

    @property
    def kernel_layers(self) -> List[Tuple[int, int]]:
        """Per layer, the (F, H) its aggregation kernels see, from the
        cell's reference module."""
        return self.cell.reference.kernel_layers(self.cell.config)

    @property
    def steps(self) -> int:
        return sum(e.steps for e in self.window.epochs)

    @property
    def epochs(self) -> int:
        return len(self.window.epochs)

    @property
    def traced_device(self) -> bool:
        """A traced run in which the card ran something: device metrics
        read nothing else (a CPU run has no device numbers)."""
        return self.trace is not None and bool(self.trace.device)

    @property
    def trace_s(self) -> float:
        lo, hi = self.trace.window
        return (hi - lo) / 1e9


def step_ms(ctx: Context) -> List[float]:
    return [ms for e in ctx.window.epochs for ms in e.step_ms]


def percentile(values: List[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between closest ranks (numpy's)."""
    return float(np.percentile(values, q)) if values else None


def idle_pct(ctx: Context, mode: str) -> Optional[float]:
    if not ctx.traced_device or ctx.mode != mode:
        return None
    busy = trace.busy_ns(ctx.trace.device, ctx.trace.window) / 1e9
    return 100.0 * (1.0 - busy / ctx.trace_s)


def per_step_mean(ctx: Context, per_step) -> Optional[float]:
    """The mean of `per_step(step)` over the counted steps (a sampled
    traced run's warm-up epoch), or None where none was counted."""
    if not ctx.shapes:
        return None
    return sum(per_step(step) for step in ctx.shapes) / len(ctx.shapes)


def step_flops_total(ctx: Context) -> Optional[float]:
    """Required FLOPs of the traced window's work, as the cell's reference
    module counts them; a sampled window's are its steps times the counted
    steps' mean."""
    ref, cfg = ctx.cell.reference, ctx.cell.config
    if ctx.mode == "sampled":
        mean = per_step_mean(ctx, lambda step: ref.step_flops(
            cfg, [row[:3] for row in step]))
        return None if mean is None else ctx.steps * mean
    return ctx.epochs * ref.epoch_flops(cfg, ctx.num_vertices,
                                        ctx.num_edges)


def mfu_pct(ctx: Context, mode: str) -> Optional[float]:
    if not ctx.traced_device or ctx.mode != mode:
        return None
    flops = step_flops_total(ctx)
    if flops is None:
        return None
    peak = flops_peak(ctx.device_name, ctx.cell.config["dtype"],
                      bool(ctx.cell.config["tf32"]))
    return 100.0 * flops / ctx.trace_s / peak


# kernel attribution reads every device event of the trace: the profiler
# runs only around the window, and a kernel at the window's edge must not
# be lost to the host and device clocks' small offset
WHOLE_TRACE = (0, 1 << 63)


def products_ms(ctx: Context, mode: str) -> Optional[float]:
    """cuBLAS's device time a step (sampled) or an epoch (whole graph)."""
    if not ctx.traced_device or ctx.mode != mode:
        return None
    ns = trace.time_in(ctx.trace.device, WHOLE_TRACE,
                       kernel_names.is_product)
    if ns == 0:
        return None
    per = ctx.steps if mode == "sampled" else ctx.epochs
    return ns / 1e6 / per


def forwards_per_epoch(cell) -> int:
    """Whole-graph forwards an epoch: training, and the METRICS clean
    forward where dropout is on."""
    c = cell.config
    return 2 if c["metrics"] == "clean" and c["drop_rate"] > 0 else 1


def roofline_pct(ctx: Context, group: str, mode: str,
                 anchor: str, launches_per_unit: int) -> Optional[float]:
    """Bytes-once bound of the group's launches over their device time.
    `anchor` names one kernel of the group that launches
    `launches_per_unit` times a step (sampled) or an epoch (whole graph);
    where the trace shows another count, the structure the bound assumes
    is not the program's and nothing is read."""
    if not ctx.traced_device or ctx.mode != mode:
        return None
    ev, win = ctx.trace.device, WHOLE_TRACE
    units = ctx.steps if mode == "sampled" else ctx.epochs
    n = trace.count(ev, win, lambda name: anchor in name)
    if n == 0 or n != launches_per_unit * units:
        return None
    ns = trace.time_in(ev, win, lambda name: kernel_names.in_group(name,
                                                                   group))
    if ns == 0:
        return None
    layers = {"layers": len(ctx.kernel_layers)}
    for l, (F, H) in enumerate(ctx.kernel_layers):
        layers.update({f"F{l}": F, f"H{l}": H})
    if mode == "sampled":
        def step_bound(step):
            shapes = dict(layers)
            for l, (nnz, _dv, _sv, D, K, S) in enumerate(step):
                shapes.update({f"D{l}": D, f"K{l}": K, f"S{l}": S,
                               f"nnz{l}": nnz})
            return bounds.kernel_bounds_per_step(group, ctx.device_name, 4,
                                                 shapes)

        mean = per_step_mean(ctx, step_bound)
        if mean is None:
            return None
        bound = units * mean
    else:
        shapes = dict(layers, V=ctx.num_vertices, E=ctx.num_edges,
                      forwards=forwards_per_epoch(ctx.cell))
        bound = units * bounds.kernel_bounds_per_step(group, ctx.device_name,
                                                      4, shapes)
    return 100.0 * bound / (ns / 1e9)
