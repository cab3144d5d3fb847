"""The device sampler's time a step: the mean over the traced window's
steps of the device interval of the program's `sample` span (its CUDA
event pair, `DeviceSampleTrainer.sample`)."""

from benchmark.spans import device_ms_per_step


def read(ctx):
    return device_ms_per_step(ctx, ("sample",))
