"""Share of the traced window in which the card was idle while the
launching thread was inside `device_epoch` or `device_step` but outside
`sample` and `train_step`: the seeds' upload (`seeds`), the loop, the
epoch's reads (`epoch_sync`)."""

from benchmark.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "sampled", "loop")
