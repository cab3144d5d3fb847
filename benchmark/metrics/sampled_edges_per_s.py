"""Valid sampled edges trained in the window (the program's own count,
`train_epoch()`'s third value) over the window's host time, which ends
in the last epoch's sync."""


def read(ctx):
    if ctx.mode != "sampled" or ctx.window.seconds <= 0:
        return None
    return sum(e.edges for e in ctx.window.epochs) / ctx.window.seconds
