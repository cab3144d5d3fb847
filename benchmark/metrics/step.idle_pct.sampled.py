"""Share of the traced window in which the card was idle while the
launching thread was inside the program's `train_step` span or its
children (`forward`, `backward`, `update`)."""

from benchmark.spans import idle_pct


def read(ctx):
    return idle_pct(ctx, "sampled", "step")
