"""The system under test, `sgnn_tpu_torch`, as the harness drives it.

This is the one module of the benchmark that imports the program.  It
builds the trainer a cell names through the program's own entry
(`build_trainer`, the engine `run_engine` builds), puts the benchmark's
weights into it, drives its first steps through its own `train_epoch()`
while it records what `correct` needs (the sampled blocks, the dropout
masks, the losses, the parameters and the optimizer's moments), then runs
the measured window on the same object.
"""

from __future__ import annotations

import dataclasses
import math
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List

import numpy as np
import torch

from sgnn_tpu_torch.config import RunConfig
from sgnn_tpu_torch.data.dataset import Dataset
from sgnn_tpu_torch.train import build_trainer
import sgnn_tpu_torch.models.gnn as _gnn_model
import sgnn_tpu_torch.train.fullbatch as _fullbatch

from .spec import Cell

CAPTURE_STEPS = 3
# where each mode's training forward looks its dropout up
DROPOUT_SITES = {"sampled": _gnn_model, "fullgraph": _fullbatch}


def make_dataset(arrays: Dict[str, np.ndarray], name: str) -> Dataset:
    return Dataset(num_vertices=int(arrays["features"].shape[0]),
                   edges=arrays["edges"], features=arrays["features"],
                   labels=arrays["labels"], masks=arrays["masks"], name=name)


def run_config(cell: Cell, seed: int, num_vertices: int) -> RunConfig:
    """The program's configuration for a cell and a run's seed."""
    c, t = cell.config, cell.traffic
    kw = dict(
        algorithm=cell.workload["algorithm"],
        layer_sizes=list(c["layer_sizes"]), heads=int(c["heads"]),
        dtype=c["dtype"], drop_rate=float(c["drop_rate"]),
        learn_rate=float(c["learn_rate"]),
        weight_decay=float(c["weight_decay"]),
        decay_rate=float(c["decay_rate"]), decay_epoch=int(c["decay_epoch"]),
        up_degree=bool(c["up_degree"]), metrics=c["metrics"], seed=int(seed),
        vertices=num_vertices, epochs=1)
    if t["mode"] == "sampled":
        kw.update(fanout=list(t["fanout"]), batch_size=int(t["batch_size"]),
                  batch_type=t["batch_type"])
    own = c.get("program", {})
    known = {f.name for f in dataclasses.fields(RunConfig)}
    unknown = sorted(set(own) - known)
    if unknown:
        raise ValueError(f"configuration {c['name']!r}: program keys "
                         f"{unknown} are not RunConfig's")
    kw.update(own)
    return RunConfig(**kw)


def build(cell: Cell, seed: int, dataset: Dataset, device):
    """The trainer the cell's ALGORITHM names, on `device`."""
    cfg = run_config(cell, seed, dataset.num_vertices)
    return build_trainer(cfg, dataset, device=device)


def core(trainer):
    """The object that holds the parameters and the optimizer state: the
    sampled trainer itself, or a whole-graph engine's FullBatchTrainer."""
    return getattr(trainer, "base", trainer)


def make_weights(cell: Cell, seed: int, device) -> List[torch.Tensor]:
    """The benchmark's initial parameters: every leaf the cell's reference
    module declares (`leaves(cfg)`), in the program's flat order, drawn on
    the device from the run's seed in one call over the drawn leaves'
    total size, a uniform leaf in +-sqrt(6/(fan_in + fan_out)), a zero
    leaf zeros."""
    decl = cell.reference.leaves(cell.config)
    total = sum(math.prod(shape) for _, shape, draw in decl
                if draw[0] == "uniform")
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32) * 2.0 - 1.0
    leaves, off = [], 0
    for name, shape, draw in decl:
        if draw[0] == "zeros":
            leaves.append(torch.zeros(shape, dtype=torch.float32,
                                      device=device))
            continue
        if draw[0] != "uniform":
            raise ValueError(f"leaf {name}: unknown draw {draw!r}")
        n = math.prod(shape)
        bound = math.sqrt(6.0 / (draw[1] + draw[2]))
        leaves.append((flat[off:off + n] * bound).view(*shape).clone())
        off += n
    return leaves


def set_weights(trainer, p0: List[torch.Tensor]) -> None:
    """Replace every parameter leaf of the program by `p0`'s, which have
    to match the program's leaves one for one in shape."""
    c = core(trainer)
    have = [tuple(t.shape) for t in c.params.leaves()]
    want = [tuple(t.shape) for t in p0]
    if have != want:
        raise ValueError(f"the reference module declares leaves {want}; "
                         f"the program holds {have}")
    c.params = c.params.replace_leaves([t.clone() for t in p0])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# ------------------------------------------------------------------ capture
@dataclasses.dataclass
class Capture:
    """What the program did in its first steps: the program's outputs
    that `correct` judges and the randomness the reference follows."""

    losses: List[float] = dataclasses.field(default_factory=list)
    p0: List[torch.Tensor] = dataclasses.field(default_factory=list)
    m1: List[torch.Tensor] = dataclasses.field(default_factory=list)
    p1: List[torch.Tensor] = dataclasses.field(default_factory=list)
    p3: List[torch.Tensor] = dataclasses.field(default_factory=list)
    # per step: the sampled layers as global ids (sampled cells)
    layers: List[List[dict]] = dataclasses.field(default_factory=list)
    # per step: one keep mask per hidden layer's dropout
    masks: List[List[torch.Tensor]] = dataclasses.field(default_factory=list)
    # dropout draws over nonzero inputs: (kept, total)
    drop_kept: int = 0
    drop_total: int = 0
    # sampled cells, over the whole epochs the capture drove: the sampled
    # edges each `train_epoch()` returned, and per step the kept slots on
    # valid destination rows of its blocks, as the harness counts them
    epoch_edges: List[int] = dataclasses.field(default_factory=list)
    step_kept: List[int] = dataclasses.field(default_factory=list)


def _global_layers(batch) -> List[dict]:
    """A sampled batch's blocks (bottom first) as global vertex ids: each
    layer's valid destinations and its slots' sources, -1 where a slot
    holds no edge (weight 0)."""
    out = []
    for blk in batch.blocks:
        valid = blk.dst_valid
        d = blk.seeds[valid].long()
        nbr = blk.srcs.long()[blk.nbr[valid].long()]
        keep = blk.weight[valid] != 0
        out.append({"dst": d, "nbr": torch.where(keep, nbr, -1),
                    "valid": valid})
    return out


@contextmanager
def _recording_dropout(site, cap: Capture, active: Callable[[], bool],
                       step_masks: List[torch.Tensor]):
    """The program's dropout, recording each call's keep mask (an output
    that is zero where its input was not) while `active()`."""
    orig = site.dropout

    def dropout(generator, x, rate, train):
        out = orig(generator, x, rate, train)
        if active() and train and rate > 0.0:
            nz = x != 0
            keep = out != 0
            cap.drop_kept += int((keep & nz).sum())
            cap.drop_total += int(nz.sum())
            step_masks.append(keep)
        return out

    site.dropout = dropout
    try:
        yield
    finally:
        site.dropout = orig


def _kept_slots(batch) -> torch.Tensor:
    """Kept slots (weight != 0) on valid destination rows, over a batch's
    blocks, as a device scalar."""
    return sum(((blk.weight != 0) & blk.dst_valid[:, None]).sum()
               for blk in batch.blocks)


def _params(trainer) -> List[torch.Tensor]:
    return [t.detach().clone() for t in core(trainer).params.leaves()]


def _moments(trainer) -> List[torch.Tensor]:
    return [t.detach().clone() for t in core(trainer).opt_state.m]


def capture_sampled(cell: Cell, trainer) -> Capture:
    """Drive whole epochs of the sampled trainer through `train_epoch()`
    until its first CAPTURE_STEPS steps and the parameters after them are
    recorded: the batch each step sampled, its dropout masks, its loss;
    the parameters before step 1, after step 1 and after step 3, the
    moments after step 1; over every step of those epochs, the kept slots
    of its blocks beside the sampled edges each epoch returned."""
    cap = Capture()
    calls = {"sample": 0}
    pending: List[torch.Tensor] = []
    kept: List[torch.Tensor] = []
    orig_sample, orig_step = trainer.sample, trainer.train_step

    def sample(seeds, valid, omit_map=None):
        k = calls["sample"]
        calls["sample"] += 1
        if k == 0:
            cap.p0 = _params(trainer)
        elif k == 1:
            cap.m1 = _moments(trainer)
            cap.p1 = _params(trainer)
        elif k == CAPTURE_STEPS:
            cap.p3 = _params(trainer)
        batch = orig_sample(seeds, valid, omit_map)
        kept.append(_kept_slots(batch))
        if k < CAPTURE_STEPS:
            cap.layers.append(_global_layers(batch))
        return batch

    def train_step(batch, cache_emb=None):
        k = calls["sample"] - 1
        pending.clear()
        loss, acc = orig_step(batch, cache_emb)
        if k < CAPTURE_STEPS:
            cap.losses.append(loss)
            cap.masks.append(list(pending))
        return loss, acc

    with _patched(trainer, "sample", sample), \
            _patched(trainer, "train_step", train_step), \
            _recording_dropout(DROPOUT_SITES[cell.mode], cap,
                               lambda: calls["sample"] <= CAPTURE_STEPS,
                               pending):
        while calls["sample"] <= CAPTURE_STEPS:
            cap.epoch_edges.append(int(trainer.train_epoch()[-1]))
    cap.losses = [float(x) for x in cap.losses]
    cap.step_kept = [int(k) for k in kept]
    return cap


def capture_fullgraph(cell: Cell, trainer) -> Capture:
    """Drive CAPTURE_STEPS whole-graph epochs through `train_epoch()`,
    recording each one's loss and dropout masks, the parameters before
    the first, after the first and after the last, the moments after the
    first."""
    cap = Capture()
    cap.p0 = _params(trainer)
    pending: List[torch.Tensor] = []
    with _recording_dropout(DROPOUT_SITES[cell.mode], cap, lambda: True,
                            pending):
        for k in range(CAPTURE_STEPS):
            pending.clear()
            loss = trainer.train_epoch()[0]
            cap.losses.append(float(loss))
            cap.masks.append(list(pending))
            if k == 0:
                cap.m1 = _moments(trainer)
                cap.p1 = _params(trainer)
    cap.p3 = _params(trainer)
    return cap


CAPTURES = {"sampled": capture_sampled, "fullgraph": capture_fullgraph}


# ------------------------------------------------------------------- window
@dataclasses.dataclass
class EpochRecord:
    seconds: float
    loss: float
    edges: int
    step_ms: List[float]
    steps: int


@dataclasses.dataclass
class Window:
    seconds: float
    epochs: List[EpochRecord]
    opened: float        # time.perf_counter() at the window's opening
    span_ns: tuple = ()  # (opening, close) on time.time_ns()
    # sampled windows on the card: host seconds inside the trainer's
    # `sample` and `train_step` calls, and in the harness's own events
    host_s: Dict[str, float] = dataclasses.field(default_factory=dict)


@contextmanager
def _patched(obj, name: str, value):
    """Set an instance attribute for the block's duration, then put back
    what the instance had (or nothing)."""
    had = name in vars(obj)
    old = vars(obj).get(name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        if had:
            setattr(obj, name, old)
        else:
            delattr(obj, name)


@contextmanager
def step_events(trainer, marks: List[list], host: Dict[str, float]):
    """The harness's own CUDA events on a sampled trainer's stream: one at
    each epoch's first `sample` call and one after every `train_step`.
    `marks` gets one list of events an epoch (the caller opens it);
    `host` adds up the host seconds spent inside `sample`, inside
    `train_step` and in recording the events."""
    orig_sample, orig_step = trainer.sample, trainer.train_step
    clock = time.perf_counter
    for key in ("sample", "train_step", "events"):
        host.setdefault(key, 0.0)

    def record():
        t = clock()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[-1].append(ev)
        host["events"] += clock() - t

    def sample(seeds, valid, omit_map=None):
        if not marks[-1]:
            record()
        t = clock()
        batch = orig_sample(seeds, valid, omit_map)
        host["sample"] += clock() - t
        return batch

    def train_step(batch, cache_emb=None):
        t = clock()
        out = orig_step(batch, cache_emb)
        host["train_step"] += clock() - t
        record()
        return out

    with _patched(trainer, "sample", sample), \
            _patched(trainer, "train_step", train_step):
        yield


def run_window(trainer, seconds: float, device, sampled: bool) -> Window:
    """Whole epochs of `train_epoch()` until `seconds` have passed; every
    epoch ends in the program's own sync.  The window is the host time
    from its opening (after a sync) to the end of its last epoch, also on
    the realtime clock a trace uses (`span_ns`).  A sampled epoch's
    step times come from the harness's events (`step_events`): the first
    step from its `sample` call to the end of its update, each later one
    from the end of the one before."""
    sync(device)
    cuda = torch.device(device).type == "cuda"
    marks: List[list] = []
    host: Dict[str, float] = {}
    timed = (step_events(trainer, marks, host) if sampled and cuda
             else nullcontext())
    epochs: List[EpochRecord] = []
    with timed:
        t_open = time.perf_counter()
        open_ns = time.time_ns()
        while True:
            marks.append([])
            t0 = time.perf_counter()
            ret = trainer.train_epoch()
            t1 = time.perf_counter()
            steps = len(getattr(core(trainer), "step_losses", None) or []) or 1
            epochs.append(EpochRecord(t1 - t0, float(ret[0]), int(ret[-1]),
                                      [], steps))
            if t1 - t_open >= seconds:
                break
        sync(device)
        t_close = time.perf_counter()
        close_ns = time.time_ns()
    for rec, evs in zip(epochs, marks):
        rec.step_ms = [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
    return Window(t_close - t_open, epochs, t_open, (open_ns, close_ns),
                  host)


@contextmanager
def counting_shapes(trainer, out: List[List[tuple]], own_rows: bool):
    """Per step of the epochs run inside the block: each layer's (kept
    edges, valid destinations, distinct source rows read, with the
    destinations' own rows where `own_rows`) as device counts and its
    padded (destinations, slots a row, sources), read into `out` when the
    block ends.  A traced run counts them in the warm-up epoch before its
    window, so that no kernel of the harness's runs inside the trace."""
    orig = trainer.sample
    counts: list = []

    def sample(seeds, valid, omit_map=None):
        batch = orig(seeds, valid, omit_map)
        per = []
        for blk in batch.blocks:
            keep = blk.weight != 0
            n_src = blk.srcs.shape[0]
            hit = torch.zeros(n_src + 1, dtype=torch.int32,
                              device=keep.device)
            idx = torch.where(keep, blk.nbr.long(), n_src)
            hit.index_fill_(0, idx.reshape(-1), 1)
            if own_rows:
                own = torch.where(blk.dst_valid, blk.seed_in_src.long(),
                                  n_src)
                hit.index_fill_(0, own, 1)
            per.append(torch.stack([keep.sum(), blk.dst_valid.sum(),
                                    hit[:n_src].sum()]))
        counts.append((torch.stack(per), [
            (blk.nbr.shape[0], blk.nbr.shape[1], blk.srcs.shape[0])
            for blk in batch.blocks]))
        return batch

    with _patched(trainer, "sample", sample):
        yield
    out.extend([tuple(int(v) for v in row) + dims
                for row, dims in zip(c.tolist(), padded)]
               for c, padded in counts)
