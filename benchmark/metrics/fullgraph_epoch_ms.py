"""The window's host time over the whole-graph epochs it completed; each
`train_epoch()` ends in the program's own sync."""


def read(ctx):
    if ctx.mode != "fullgraph" or not ctx.window.epochs:
        return None
    return 1e3 * ctx.window.seconds / len(ctx.window.epochs)
