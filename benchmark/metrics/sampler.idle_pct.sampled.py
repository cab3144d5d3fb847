"""Share of the traced window in which the card was idle while the
launching thread was inside the program's `sample` span (each idle gap
goes to the innermost span open at its middle, benchmark/spans.py)."""

from benchmark.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "sampled", "sampler")
