"""Divergence detection: fail fast on a non-finite training loss (the
port's copy of sgnn_tpu/train/guard.py).

The reference has no failure detection at all — its only handler is a
SIGSEGV stacktrace printer (toolkits/main.cpp:37-41), so a diverged run
(learning rate too high, bad input data, fp overflow) silently keeps
training NaN weights to the last epoch and reports garbage accuracy.

Here every engine's epoch loop checks the loss the moment it reaches the
host (it is already transferred for logging, so the check is free) and
raises :class:`DivergenceError`.  Adam cannot recover once the parameters
are poisoned by a NaN gradient — continuing only wastes accelerator time —
and with ``--checkpoint-dir`` the error names the last good checkpoint so
the run can resume below the cliff.
"""

from __future__ import annotations

import math

from ..utils.logging import get_logger

log = get_logger("sgnn.guard")


class DivergenceError(RuntimeError):
    """Training loss became NaN/Inf; parameters are no longer trustworthy."""

    def __init__(self, loss: float, epoch: int, where: str,
                 last_good_epoch: int | None = None):
        self.loss = loss
        self.epoch = epoch
        self.last_good_epoch = last_good_epoch
        msg = (
            f"{where}: loss became {loss!r} at epoch {epoch} — training has "
            "diverged (common causes: LEARN_RATE too high, unnormalized "
            "features, fp overflow in bf16)."
        )
        if last_good_epoch is not None:
            msg += (
                f" Last good checkpoint is epoch {last_good_epoch}; resume "
                "with --checkpoint-dir/--resume after lowering LEARN_RATE."
            )
        super().__init__(msg)


def check_finite_loss(loss: float, epoch: int, where: str,
                      last_good_epoch: int | None = None) -> None:
    """Raise DivergenceError if the host-side epoch loss is NaN/Inf."""
    if not math.isfinite(loss):
        log.error("%s: non-finite loss %r at epoch %d", where, loss, epoch)
        raise DivergenceError(loss, epoch, where, last_good_epoch)
