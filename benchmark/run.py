#!/usr/bin/env python3
"""Run one cell of the benchmark of `sgnn_tpu_torch` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

from the root of a checkout.  The cell (an entry of BENCHMARK.json's
`workloads`) names a configuration, a traffic mix and the files under
`benchmark/` that belong to them.  One run:

  1. set-up: the cell's files and its reference module (which also
     declares the architecture: the parameter leaves, FLOPs and kernel
     shapes), the graph (cached under build/benchmark/graphs/), the trainer
     through the program's own `build_trainer`, the benchmark's weights
     drawn on the card from --seed, the first three training steps driven
     through the trainer's own `train_epoch()` while what `correct` needs
     is recorded, one more warm epoch (with --trace 1 in a sampled cell,
     its steps' shapes counted for the per-layer readings);
  2. the window: whole epochs of `train_epoch()` for --seconds (with
     --trace 1, at most the traffic's `trace_seconds`, under
     torch.profiler);
  3. the device's peak memory, the card's name, power limit and clocks (an
     earlier line of standard output), then the program's state freed and
     the reference run over the three recorded steps.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or its
per-layer metrics with --trace 1), `device`, with --trace 1 `breakdown`,
and last `checks`, each number `correct` compared beside its limit; the
same numbers are the last lines of standard error.  Exit codes: 0 with a
result; 2 without a card (or fewer cards than the cell needs) or with a
cell that is not there; 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import os  # noqa: E402

# one process with few threads: the program's host work is one launching
# thread, and idle pools of CPU threads only contend with it on a shared
# host; set before torch and numpy load their thread pools
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in the process that prints
# a result: the JAX stack and the JAX package the port was made from
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sgnn_tpu")


@dataclasses.dataclass
class Options:
    """Where a run looks and what it may skip; the defaults are a real
    run's.  Tests run the rest of a run on the CPU with their own files."""

    bench_file: Path = ROOT / "BENCHMARK.json"
    bench_dir: Path = ROOT / "benchmark"
    graph_cache: Optional[Path] = None
    device: Optional[str] = None          # None: the card
    require_chip: bool = True
    # called with the built trainer before its first step (tests plant
    # faults in the program through it)
    after_build: Optional[Callable] = None


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_loaded() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def card_info() -> dict:
    """The card's name, power limit and clocks, from nvidia-smi."""
    q = "name,power.limit,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unavailable: {exc}"}
    return {"nvidia_smi": out.strip().splitlines()[0] if out.strip() else ""}


def run(args: argparse.Namespace, opt: Options, out=sys.stdout,
        err=sys.stderr) -> int:
    import torch

    torch.set_num_threads(1)
    from benchmark import graph, readings, spec, trace

    try:
        cell = spec.load_cell(args.workload, opt.bench_file, opt.bench_dir)
    except (KeyError, FileNotFoundError) as exc:
        print(f"run.py: {exc}", file=err)
        return 2
    if opt.require_chip and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " visible", file=err)
        return 2
    device = torch.device(opt.device or "cuda:0")
    cuda = device.type == "cuda"
    if cuda:
        tf32 = bool(cell.config["tf32"])
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    from benchmark import correctness, program

    # ---------------------------------------------------------- set-up
    arrays = graph.load_graph(cell.config["graph"],
                              opt.graph_cache or graph.CACHE_DIR)
    dataset = program.make_dataset(arrays, cell.config["name"])
    trainer = program.build(cell, args.seed, dataset, device)
    p0 = program.make_weights(cell, args.seed, device)
    program.set_weights(trainer, p0)
    if opt.after_build is not None:
        opt.after_build(trainer)
    cap = program.CAPTURES[cell.mode](cell, trainer)
    sampled = cell.mode == "sampled"
    # a traced sampled run counts its steps' shapes in the warm-up, which
    # runs the window's epochs untraced
    shapes: list = []
    counting = (program.counting_shapes(
        trainer, shapes, cell.reference.reads_own_rows(cell.config))
        if args.trace and sampled else contextlib.nullcontext())
    with counting:
        for _ in range(int(cell.traffic.get("warmup_epochs", 1))):
            trainer.train_epoch()
    program.sync(device)

    # ---------------------------------------------------------- window
    traced = None
    cpu_open = time.process_time()
    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        seconds = min(args.seconds, float(cell.traffic["trace_seconds"]))
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        with profile(activities=acts) as prof:
            window = program.run_window(trainer, seconds, device, sampled)
        traced = trace.from_profiler(prof, window.span_ns)
        print(json.dumps({"trace": trace.launch_summary(traced)}), file=out,
              flush=True)
    else:
        window = program.run_window(trainer, args.seconds, device, sampled)
    # the process's CPU seconds in the window (a spinning sync counts; a
    # traced run adds the profiler's collection): under the window's
    # length where the process was off the CPU
    window_cpu_s = time.process_time() - cpu_open
    setup_s = window.opened - T_START
    memory_peak = (torch.cuda.max_memory_allocated(device) if cuda else 0)

    ctx = readings.Context(
        cell=cell, setup_s=setup_s, window=window,
        device_name=(torch.cuda.get_device_name(device) if cuda
                     else "cpu"),
        num_vertices=int(arrays["features"].shape[0]),
        num_edges=int(arrays["edges"].shape[0]), trace=traced,
        shapes=shapes or None)
    metrics = spec.read_metrics(cell.per_layer if args.trace
                                else cell.end_to_end, ctx, opt.bench_dir)
    dev = {"platform": "gpu" if cuda else "cpu", "kind": ctx.device_name,
           "count": cell.chips if cuda else 1,
           "memory_peak_bytes": int(memory_peak)}
    result = {}
    if traced is not None and cuda:
        dev["busy_s"] = trace.busy_ns(traced.device, traced.window) / 1e9
        dev["window_s"] = ctx.trace_s
        result["breakdown"] = {
            "device_ops": trace.top_device_ops(traced.device, traced.window),
            "idle_gaps": trace.idle_by_host(traced)}
    if cuda:
        ep = sorted(e.seconds for e in window.epochs)
        host = dict(window.host_s)
        if host:
            # the rest of the epochs' host time: the seeds' order and
            # upload, the loop, and each epoch's closing sync
            host["rest"] = sum(ep) - sum(host.values())
        print(json.dumps({"card": card_info(),
                          "window_epochs": len(window.epochs),
                          "window_steps": ctx.steps,
                          "epoch_s_min_median_max": [
                              ep[0], ep[len(ep) // 2], ep[-1]],
                          "host_s": host,
                          "process_cpu_s": window_cpu_s,
                          "step_ms_p50_p95": [
                              readings.percentile(readings.step_ms(ctx), q)
                              for q in (50, 95)]}),
              file=out, flush=True)

    # ----------------------------------------------------- correctness
    del trainer, dataset
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    inp = correctness.Inputs(arrays, device, cell.reference)
    numbers = correctness.judge(cell, inp, cap)
    checked = correctness.checks(numbers, cell.limits)
    failed = sum(e.steps for e in window.epochs if not math.isfinite(e.loss))
    result = {"correct": correctness.passed(checked),
              "attempted": ctx.steps, "failed": failed, "metrics": metrics,
              "device": dev, **result, "checks": checked}
    forbidden = forbidden_loaded()
    if forbidden:
        print(f"run.py: the process loaded {', '.join(forbidden)}", file=err)
        return 3
    for name, c in checked.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


def main(argv=None) -> int:
    return run(parse_args(argv), Options())


if __name__ == "__main__":
    sys.exit(main())
