"""Set-up: process start until the measured window opens (imports, the
graph, the trainer's build, the kernels' first load or build, the first
steps that `correct` follows, one more warm epoch)."""


def read(ctx):
    return ctx.setup_s
