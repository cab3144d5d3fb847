"""Device time of cuBLAS's products per step of the traced window.  Not
read where the sampled model is GAT: there cuBLAS also runs the edge
tensors' einsums, which aggregate, and no kernel name tells them from the
dense products."""

from benchmark.readings import products_ms


def read(ctx):
    if ctx.family == "gat":
        return None
    return products_ms(ctx, "sampled")
