"""The layers' attention a step: the mean over the traced window's steps
of the device intervals of the program's `attention` spans (each PyG
layer's attention after its transforms, forward only: GATConv's score
tables and GS's forward, or GATv2's forward kernel), summed within the
step.  A program without the span reads nothing."""

from benchmark.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("attention",))
