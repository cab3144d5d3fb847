"""The model's time a step: the mean over the traced window's steps of
the device intervals of the program's `forward` (model forward and loss)
and `backward` spans, summed within the step."""

from benchmark.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("forward", "backward"))
