"""Multi-host training: one process a card, joined over TCP, and its drivers.

The port of sgnn_tpu/parallel/multihost.py.  Reference: the MPI bootstrap
(dep/gemini/mpi.hpp:51, MPI_Init_thread) and per-rank vertex ranges
(core/graph.hpp:391).  The JAX package joins every host into one
`jax.distributed` runtime and lays every chip into one mesh; here every
process drives one card and `initialize_distributed` joins the processes
into one `torch.distributed` group through a TCP store that rank 0 hosts
at the coordinator's address (NCCL between cards, gloo when the caller
asked for the CPU).  On one machine torchrun does the same
(`parallel/mesh.make_group`); the coordinator is what several machines
share.

The drivers keep the JAX names and contracts, over the port's trainers:
- `run_multihost_dp_epochs`: host-sampled data parallelism whose batches
  are the JAX driver's bit for bit (its numpy streams, below);
- `run_multihost_fullbatch_epochs`: vertex-partitioned whole-graph
  training, `FullBatchTrainer(mesh=global_mesh(graph=world))`, each rank
  holding only its own rows (parallel/halo.py);
- `run_multihost_device_dp_epochs` and `run_multihost_pcmulti_epochs`:
  the device-sampled data-parallel trainers (parallel/dp_device.py).
Each returns the per-epoch losses, equal on every rank.  The checkpoint
pair writes the replicated state once (rank 0) on a filesystem every rank
reads, as the JAX pair does; it is not sharded.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device
from ..sampler.blocks import WeightKind
from ..train.guard import check_finite_loss
from ..utils.logging import get_logger
from .mesh import DataGroup, backend_for, make_group, process_world_size

log = get_logger("sgnn.dist")

# how long a rank waits for its peers at the join (and NCCL for a
# collective) before it fails instead of hanging: the JAX default
JOIN_TIMEOUT_S = 300.0

_WEIGHT_KIND = {"gcn": WeightKind.GCN, "sage": WeightKind.MEAN,
                "gat": WeightKind.NONE}


def _rank_device(device=None, process_id: int = 0) -> torch.device:
    """The card of a rank: `cuda:{LOCAL_RANK}` when the launcher set it,
    else `cuda:{process_id % device_count}`; the CPU only when asked."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else process_id % torch.cuda.device_count())
    return torch.device("cuda", index)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device=None,
                           timeout_s: float = JOIN_TIMEOUT_S
                           ) -> Tuple[int, int]:
    """Join the group; returns (rank, world size).

    With `coordinator_address` ("host:port"), this process joins
    `num_processes` ranks as rank `process_id` through the TCP store at
    that address (rank 0 hosts it), on `_rank_device(device, process_id)`
    with its backend (`mesh.backend_for`: NCCL on a card, gloo on the CPU,
    which only `device="cpu"` gives).  A peer that does not arrive within
    `timeout_s` fails the join.  Without one, the join is
    `parallel/mesh.make_group`'s (torchrun's environment, or one rank).
    An initialised group is kept."""
    if not dist.is_initialized():
        if coordinator_address is None:
            make_group(device)
        else:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator needs num_processes and "
                                 "process_id")
            dev = _rank_device(device, process_id)
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            dist.init_process_group(
                backend_for(dev), init_method=f"tcp://{coordinator_address}",
                world_size=int(num_processes), rank=int(process_id),
                timeout=datetime.timedelta(seconds=timeout_s))
    rank, world = dist.get_rank(), dist.get_world_size()
    log.info("distributed init: rank %d of %d (%s)", rank, world,
             dist.get_backend())
    return rank, world


def global_mesh(data: Optional[int] = None, graph: int = 1,
                device=None) -> DataGroup:
    """This process's group over every rank: the data axis (graph=1) or
    the graph axis (graph = the world size, one vertex range a rank).
    `data` × `graph` must be the world size; a mixed data × graph layout
    raises NotImplementedError (parallel/mesh.make_group), as the port's
    whole-graph trainer shards over every rank of its group."""
    world = process_world_size()
    if data is not None and data * graph != world:
        raise ValueError(f"data={data} × graph={graph} ranks, but the group "
                         f"has {world}")
    return make_group(device, graph=graph)


def _sync(group: DataGroup) -> None:
    if group.device.type == "cuda":
        torch.cuda.synchronize(group.device)


def _finish_epoch(group: DataGroup, loss: float, ep: int, where: str,
                  epoch_times: Optional[List[float]], t0: float) -> None:
    _sync(group)
    if epoch_times is not None:
        epoch_times.append(time.perf_counter() - t0)
    check_finite_loss(loss, ep, where)
    log.info("%s epoch %d (%d ranks): loss %.6f", where, ep,
             group.world_size, loss)


# ------------------------------------------------------------ host-sampled
def multihost_epoch_seeds(seed: int, train_nids: np.ndarray, batch_size: int,
                          ep: int, rank: int, world: int
                          ) -> List[np.ndarray]:
    """This rank's seed chunk of each step of epoch `ep`, the JAX driver's
    split: the order `default_rng((seed, 11, ep)).permutation(train_nids)`,
    `np.array_split` over the ranks, BATCH_SIZE chunks; every rank takes
    the longest shard's number of steps, an exhausted shard an empty
    chunk (the step's dummy)."""
    order = np.random.default_rng((seed, 11, ep)).permutation(
        train_nids).astype(np.int32)
    shards = np.array_split(order, world)
    n_steps = max((len(s) + batch_size - 1) // batch_size for s in shards)
    mine = shards[rank]
    return [mine[st * batch_size:(st + 1) * batch_size]
            for st in range(n_steps)]


def multihost_step_rng(seed: int, ep: int, st: int,
                       rank: int) -> np.random.Generator:
    """The sampling stream of rank `rank` at step `st` of epoch `ep`, the
    JAX driver's `default_rng((seed, 13, ep, st, device))`: a batch does
    not depend on how the ranks are spread over processes or hosts."""
    return np.random.default_rng((seed, 13, ep, st, rank))


def run_multihost_dp_epochs(cfg, dataset, epochs: int = 1,
                            family: str = "gcn", device=None,
                            mesh: Optional[DataGroup] = None,
                            epoch_times: Optional[List[float]] = None
                            ) -> List[float]:
    """Host-sampled data parallelism over every rank of the group
    (`global_mesh()`, or `mesh`): each rank samples only its own seed
    chunks, with the JAX driver's streams (`multihost_epoch_seeds`,
    `multihost_step_rng`), so its batches are the JAX driver's bit for
    bit; an exhausted shard trains a dummy seed with no valid label.  The
    gradients are summed over the ranks (`reduce_grads`) before the
    replicated update, and the epoch's loss is the mean over its steps of
    the mean over the ranks (sgnn_tpu/parallel/multihost.py:117-222).
    Dropout draws from each rank's torch generator (rank 0's the base
    trainer's), not the JAX keys.  Every driver takes `device` (None
    means CUDA) or the group itself (`mesh`, e.g. one with `timed` set),
    and `epoch_times`, which receives each epoch's host seconds, ending in
    a device sync.  Returns the per-epoch losses, the same on every
    rank."""
    from ..train.trainer import SampleTrainer
    from .dp import DataParallelWrapper

    group = mesh if mesh is not None else global_mesh(device=device)
    base = SampleTrainer(cfg, dataset, family=family,
                         weight_kind=_WEIGHT_KIND[family],
                         device=group.device)
    DataParallelWrapper(base, group)   # the gradient SUM, rank generators
    bs = cfg.batch_size
    epoch_losses = []
    for ep in range(epochs):
        t0 = time.perf_counter()
        losses = []
        chunks = multihost_epoch_seeds(cfg.seed, base.train_nids, bs, ep,
                                       group.rank, group.world_size)
        for st, seeds in enumerate(chunks):
            dummy = seeds.size == 0
            if dummy:
                seeds = np.zeros(1, np.int32)
            base.sampler.rng = multihost_step_rng(cfg.seed, ep, st,
                                                  group.rank)
            batch, _ = base._upload(base._make_batch(seeds))
            if dummy:
                batch = dataclasses.replace(
                    batch, label_valid=torch.zeros_like(batch.label_valid))
            loss, _acc = base.train_step(batch)
            losses.append(loss)
        per_step = group.all_reduce_sum_(
            torch.stack(losses).double()) / group.world_size
        epoch_losses.append(float(per_step.mean()))
        _finish_epoch(group, epoch_losses[-1], ep, "run_multihost_dp_epochs",
                      epoch_times, t0)
    return epoch_losses


# -------------------------------------------------------------- whole graph
def run_multihost_fullbatch_epochs(cfg, dataset, epochs: Optional[int] = None,
                                   family: str = "gcn",
                                   halo: str = "all_gather",
                                   weight_kind: Optional[WeightKind] = None,
                                   state_out: Optional[dict] = None,
                                   resume_state: Optional[dict] = None,
                                   device=None,
                                   mesh: Optional[DataGroup] = None,
                                   epoch_times: Optional[List[float]] = None
                                   ) -> List[float]:
    """Vertex-partitioned whole-graph training over every rank:
    `FullBatchTrainer(mesh=global_mesh(graph=world), halo=halo)` (or
    `mesh`), every rank holding its own vertex range's rows and shard.
    `resume_state` (`multihost_checkpoint_restore`'s) restores the
    parameters, Adam and the dropout generator before the first epoch, and
    `state_out` receives them after the last, so two halves through a
    checkpoint train as one run, bit for bit.  Returns the per-epoch
    losses, the same on every rank."""
    from ..train.fullbatch import FullBatchTrainer

    if weight_kind is None:
        weight_kind = _WEIGHT_KIND[family]
    group = (mesh if mesh is not None
             else global_mesh(graph=process_world_size(), device=device))
    tr = FullBatchTrainer(cfg, dataset, family=family,
                          weight_kind=weight_kind, mesh=group, halo=halo)
    if resume_state is not None:
        tr.load_checkpoint_state(resume_state["state"])
    losses = []
    for ep in range(epochs or cfg.epochs):
        t0 = time.perf_counter()
        losses.append(tr.train_epoch()[0])
        _finish_epoch(group, losses[-1], ep, "run_multihost_fullbatch_epochs",
                      epoch_times, t0)
    if state_out is not None:
        state_out.update(tr.checkpoint_state())
    return losses


# ----------------------------------------------------------- device-sampled
def _device_dp_epochs(dp, epochs: int, where: str,
                      resume_state: Optional[dict],
                      state_out: Optional[dict],
                      epoch_times: Optional[List[float]]) -> List[float]:
    if resume_state is not None:
        dp.load_checkpoint_state(resume_state["state"])
    losses = []
    for ep in range(epochs):
        t0 = time.perf_counter()
        losses.append(dp.train_epoch()[0])
        _finish_epoch(dp.group, losses[-1], ep, where, epoch_times, t0)
    if state_out is not None:
        state_out.update(dp.checkpoint_state())   # a collective
    return losses


def run_multihost_device_dp_epochs(cfg, dataset,
                                   epochs: Optional[int] = None,
                                   family: str = "gcn",
                                   shard_features: bool = False,
                                   state_out: Optional[dict] = None,
                                   resume_state: Optional[dict] = None,
                                   device=None,
                                   mesh: Optional[DataGroup] = None,
                                   epoch_times: Optional[List[float]] = None
                                   ) -> List[float]:
    """Device-sampled data parallelism (the *ALLMULTI engines) over every
    rank: `DeviceDataParallelTrainer` over the group, SHARD_FEATURES
    row-sharding the features over the ranks.  The state (`state_out`,
    `resume_state`) is the trainer's checkpoint: parameters, Adam, and
    every rank's streams (device sampling, dropout, and the host
    generator of the epoch order).  Returns the per-epoch losses, the same
    on every rank."""
    from ..train.device_trainer import DeviceSampleTrainer
    from .dp_device import DeviceDataParallelTrainer

    group = mesh if mesh is not None else global_mesh(device=device)
    base = DeviceSampleTrainer(cfg, dataset, family=family,
                               weight_kind=_WEIGHT_KIND[family],
                               device=group.device)
    dp = DeviceDataParallelTrainer(base, group, shard_features=shard_features)
    return _device_dp_epochs(dp, epochs or cfg.epochs,
                             "run_multihost_device_dp_epochs", resume_state,
                             state_out, epoch_times)


def run_multihost_pcmulti_epochs(cfg, dataset, epochs: Optional[int] = None,
                                 family: str = "gcn", device=None,
                                 mesh: Optional[DataGroup] = None,
                                 state_out: Optional[dict] = None,
                                 epoch_times: Optional[List[float]] = None
                                 ) -> List[float]:
    """*PCMULTI over every rank: `DeviceCachedDataParallelTrainer` over a
    `DeviceCachedSampleTrainer` with one global hot set (`per_sb=False`),
    whose refresh every rank recomputes from the replicated parameters.
    `state_out` receives the trainer's checkpoint after the last epoch.
    Returns the per-epoch losses, the same on every rank."""
    from ..train.device_cached import DeviceCachedSampleTrainer
    from .dp_device import DeviceCachedDataParallelTrainer

    group = mesh if mesh is not None else global_mesh(device=device)
    base = DeviceCachedSampleTrainer(cfg, dataset, family=family,
                                     weight_kind=_WEIGHT_KIND[family],
                                     device=group.device, per_sb=False)
    dp = DeviceCachedDataParallelTrainer(base, group)
    losses = _device_dp_epochs(dp, epochs or cfg.epochs,
                               "run_multihost_pcmulti_epochs", None,
                               state_out, epoch_times)
    log.info("multihost pcmulti: cache hits %d of %d lookups",
             base.cache_hits, base.cache_lookups)
    return losses


# -------------------------------------------------------------- checkpoints
def _barrier() -> None:
    """Every rank of the initialised group waits here (NCCL names the
    card it syncs on); nothing without a group of more than one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def multihost_checkpoint_save(directory: str, step: int, state: dict) -> str:
    """Rank 0 writes `state` (a driver's `state_out`: tensors, lists,
    dicts, numbers and strings) to `directory/step_<step>.pt` through a
    temporary file; every rank then waits at a barrier, so a restore on
    any rank sees the file.  The directory is one that every rank reads (a
    shared filesystem across hosts).  Returns the file."""
    path = os.path.join(directory, f"step_{int(step)}.pt")
    if not dist.is_initialized() or dist.get_rank() == 0:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        log.info("multihost checkpoint saved: step %d -> %s", step, path)
    _barrier()
    return path


def multihost_checkpoint_restore(directory: str,
                                 step: Optional[int] = None
                                 ) -> Optional[dict]:
    """`{"step": int, "state": dict}` of the newest (or the given) step in
    `directory`, read by every rank (`torch.load(weights_only=True)`: no
    code runs while it is read), or None when there is none."""
    found = {}
    for f in glob.glob(os.path.join(directory, "step_*.pt")):
        tag = os.path.basename(f)[5:-3]
        if tag.isdigit():
            found[int(tag)] = f
    if not found:
        return None
    step = max(found) if step is None else int(step)
    if step not in found:
        raise FileNotFoundError(f"no checkpoint step {step} in {directory} "
                                f"(have {sorted(found)})")
    state = torch.load(found[step], map_location="cpu", weights_only=True)
    return {"step": step, "state": state}
