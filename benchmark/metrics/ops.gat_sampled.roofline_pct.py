"""The sampled GAT kernel pair (`ops/cuda/gat_sampled`: the forward, the
backward's destination pass, its slot transpose and source walk, and
each row's dtd summed onto its source row): the bytes-once bound of each
step's launches at their padded shapes and counted edges, with the
(F, H) of the cell's reference module, over the device time of those
kernels.  Two forward launches a step (one a layer) are what the bound
assumes."""

from benchmark.readings import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "gat_sampled", "sampled",
                        "gat_sampled_fwd_kernel", len(ctx.kernel_layers))
