"""Device time of cuBLAS's products per step of the traced window: the
layers' transforms, the GAT score tables and their gradients.  No
sampled layer aggregates in cuBLAS (K1 and the sampled GAT pair are the
port's own kernels), so every kernel the patterns meet is a dense
product."""

from benchmark.readings import products_ms


def read(ctx):
    return products_ms(ctx, "sampled")
