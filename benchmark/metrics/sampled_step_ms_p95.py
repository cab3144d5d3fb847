"""95th percentile over every step of the window of the step's
device-timeline interval (the CUDA events the trainer records after each
step, `DeviceSampleTrainer.step_ms`)."""

from benchmark.readings import percentile, step_ms


def read(ctx):
    if ctx.mode != "sampled":
        return None
    return percentile(step_ms(ctx), 95.0)
