"""Seconds of the program's `build` span (`train/engines.build_trainer`:
the transposed CSR, the source pads, the uploads), recorded with or
without a profiler session."""

from benchmark.spans import build_s


def read(ctx):
    return build_s(ctx)
