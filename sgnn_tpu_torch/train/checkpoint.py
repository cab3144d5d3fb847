"""Checkpoint / resume of training state, in one torch-native format.

The port's counterpart of sgnn_tpu/train/checkpoint.py.  Reference status
(SURVEY.md §5): no model checkpointing at all; this module supplies it as
the survey's designated improvement.

A checkpoint is `directory/step_N/state.pt`: one `torch.save` of the
trainer's `checkpoint_state()`, a dict of CPU tensors, lists, ints and
strings — parameters, optimizer moments and step, and every random stream
the next epoch draws from (`torch.Generator.get_state()` bytes; the host
sampler's numpy PCG64 state as a [6] uint64 tensor, since
`torch.load(weights_only=True)` refuses numpy's pickles).  It loads with
`torch.load(path, map_location="cpu", weights_only=True)`: no code runs
while it is read.  A save is written to a temporary file and renamed into
place, so a crash mid-save leaves the previous checkpoints intact; the
newest `max_to_keep` steps are kept.
"""

from __future__ import annotations

import os
import re
import shutil
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models.gnn import GNNParams
from ..nn.optim import AdamState, SGDState
from ..utils.logging import get_logger
from .guard import check_finite_loss

log = get_logger("sgnn.ckpt")

STATE_FILE = "state.pt"
_STEP_DIR = re.compile(r"^step_(\d+)$")
_M64 = (1 << 64) - 1


def encode_np_rng(rng: np.random.Generator) -> np.ndarray:
    """A PCG64 Generator's state as a fixed-shape [6] uint64 array
    (128-bit state and increment split hi/lo, then the cached uint32)."""
    st = rng.bit_generator.state
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array([s >> 64, s & _M64, inc >> 64, inc & _M64,
                     st["has_uint32"], st["uinteger"]], dtype=np.uint64)


def decode_np_rng(rng: np.random.Generator, arr) -> None:
    """Restore a Generator state saved by encode_np_rng (in place)."""
    a = [int(x) for x in np.asarray(arr, dtype=np.uint64).ravel()]
    st = rng.bit_generator.state
    st["state"]["state"] = (a[0] << 64) | a[1]
    st["state"]["inc"] = (a[2] << 64) | a[3]
    st["has_uint32"], st["uinteger"] = int(a[4]), int(a[5])
    rng.bit_generator.state = st


def np_rng_state(rng: np.random.Generator) -> torch.Tensor:
    """encode_np_rng as a tensor, the form a checkpoint stores."""
    return torch.from_numpy(encode_np_rng(rng))


def params_state(params: GNNParams) -> Dict[str, List[torch.Tensor]]:
    return {name: [t.detach().cpu() for t in group]
            for name, group in zip(GNNParams._fields, params)}


def _same_shapes(name: str, got: Sequence[torch.Tensor],
                 like: Sequence[torch.Tensor]) -> None:
    if [tuple(t.shape) for t in got] != [tuple(t.shape) for t in like]:
        raise ValueError(
            f"checkpoint {name} shapes {[tuple(t.shape) for t in got]} do "
            f"not match the trainer's {[tuple(t.shape) for t in like]}")


def load_params(state: dict, like: GNNParams) -> GNNParams:
    """The checkpoint's parameters on `like`'s device and dtype, after
    checking they have `like`'s shapes (another model's checkpoint
    raises; a group a checkpoint lacks is empty)."""
    groups = []
    for name, group in zip(GNNParams._fields, like):
        got = list(state.get(name, []))
        _same_shapes(name, got, group)
        groups.append(tuple(t.to(l.device, l.dtype)
                            for t, l in zip(got, group)))
    return GNNParams(*groups)


def opt_state_dict(opt_state) -> dict:
    if isinstance(opt_state, AdamState):
        return {"kind": "adam", "step": int(opt_state.step),
                "m": [t.detach().cpu() for t in opt_state.m],
                "v": [t.detach().cpu() for t in opt_state.v]}
    return {"kind": "sgd", "step": int(opt_state.step)}


def load_opt_state(state: dict, like):
    """The optimizer state of a checkpoint, in the form and on the device
    of the trainer's current state `like`."""
    kind = "adam" if isinstance(like, AdamState) else "sgd"
    if state["kind"] != kind:
        raise ValueError(f"checkpoint optimizer {state['kind']!r} does not "
                         f"match the trainer's {kind!r}")
    if kind == "sgd":
        return SGDState(step=int(state["step"]))
    _same_shapes("Adam moments", state["m"], like.m)
    _same_shapes("Adam moments", state["v"], like.v)
    return AdamState(
        m=tuple(t.to(l.device) for t, l in zip(state["m"], like.m)),
        v=tuple(t.to(l.device) for t, l in zip(state["v"], like.v)),
        step=int(state["step"]))


class CheckpointManager:
    """Save and restore a trainer's `checkpoint_state()` under
    `directory/step_N/`, keeping the newest `max_to_keep` steps."""

    def __init__(self, directory: str, max_to_keep: int = 3) -> None:
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        found = (_STEP_DIR.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m and os.path.isfile(
            os.path.join(self.directory, m.group(0), STATE_FILE)))

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}", STATE_FILE)

    def save(self, step: int, trainer) -> str:
        """Write the trainer's state as step `step`; returns the file.  A
        data-parallel trainer's state is its base trainer's, replicated
        over the ranks (sgnn_tpu/train/checkpoint.py:55-56), with each
        rank's own random streams: every rank makes it, rank 0 writes it,
        and every rank waits for the file before going on."""
        path = self.path(step)
        group = getattr(trainer, "group", None)
        state = trainer.checkpoint_state()   # on every rank: it gathers
        if group is None or group.rank == 0:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)
            for old in self.steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.dirname(self.path(old)),
                              ignore_errors=True)
            log.info("checkpoint saved: step %d → %s", step, path)
        if group is not None and group.world_size > 1:
            group.barrier()
        return path

    def restore(self, trainer, step: Optional[int] = None) -> Optional[int]:
        """Load step `step` (the newest when None) into the trainer in
        place; returns the restored step, or None when there is none."""
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1] if step is None else step
        if step not in steps:
            raise FileNotFoundError(f"no checkpoint step {step} in "
                                    f"{self.directory} (have {steps})")
        state = torch.load(self.path(step), map_location="cpu",
                           weights_only=True)
        trainer.load_checkpoint_state(state)
        log.info("checkpoint restored: step %d", step)
        return step


def run_with_checkpointing(trainer, directory: str, epochs: int,
                           resume: bool = True):
    """Epoch loop with a checkpoint every epoch and resume from the newest
    one.

    Each epoch trains, checks the loss (a non-finite loss raises
    DivergenceError naming the last good checkpoint, and the poisoned
    state is never saved), evaluates the validation and test vertices, as
    `run()` does, and then saves, so a resumed run draws what the
    uninterrupted run draws next.  Returns the TrainReport of the epochs
    this call ran (none when the newest checkpoint is the last epoch)."""
    from ..utils.timing import PhaseTimer
    from .trainer import TrainReport

    mgr = CheckpointManager(directory)
    start = 0
    if resume:
        restored = mgr.restore(trainer)
        if restored is not None:
            start = restored + 1
            log.info("resuming at epoch %d of %d", start, epochs)
    last_saved = start - 1 if start > 0 else None
    report = TrainReport([], [], [], [], [], [],
                         getattr(trainer, "timers", None) or PhaseTimer(),
                         time_skip=trainer.cfg.time_skip)
    owner = getattr(trainer, "base", trainer)
    cuda = owner.device.type == "cuda"
    for ep in range(start, epochs):
        t0 = time.perf_counter()
        loss, acc, edges = trainer.train_epoch()
        check_finite_loss(loss, ep, type(trainer).__name__,
                          last_good_epoch=last_saved)
        if cuda:
            torch.cuda.synchronize(owner.device)
        dt = time.perf_counter() - t0
        va = trainer.evaluate(owner.val_nids) if owner.val_nids.size else 0.0
        te = trainer.evaluate(owner.test_nids) if owner.test_nids.size else 0.0
        for lst, val in ((report.epoch_times, dt), (report.losses, loss),
                         (report.train_acc, acc), (report.val_acc, va),
                         (report.test_acc, te),
                         (report.edges_per_epoch, edges)):
            lst.append(val)
        log.info("epoch %d: loss %.5f train %.4f val %.4f test %.4f "
                 "time %.3fs", ep, loss, acc, va, te, dt)
        mgr.save(ep, trainer)
        last_saved = ep
    return report
