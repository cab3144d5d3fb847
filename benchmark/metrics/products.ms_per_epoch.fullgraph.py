"""Device time of cuBLAS's products per whole-graph epoch."""

from benchmark.readings import products_ms


def read(ctx):
    return products_ms(ctx, "fullgraph")
