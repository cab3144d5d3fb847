"""The layers' epilogue a step: the mean over the traced window's steps
of the device intervals of the program's `epilogue` spans (each layer's
skip product, bias, head mean, ELU and dropout in the forward), summed
within the step.  A program without the span reads nothing."""

from benchmark.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("epilogue",))
