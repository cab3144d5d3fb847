"""K2 (`ops/cuda/spmm`: forward in the training and the METRICS clean
forward, backward over the transposed CSR): the bytes-once bound of an
epoch's launches over their device time."""

from benchmark.readings import forwards_per_epoch, roofline_pct


def read(ctx):
    layers = len(ctx.kernel_layers)
    return roofline_pct(ctx, "spmm", "fullgraph", "spmm_csr_kernel",
                        forwards_per_epoch(ctx.cell) * layers)
