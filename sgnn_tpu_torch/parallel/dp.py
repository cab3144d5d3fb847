"""Data-parallel training over the host sampler (the *MULTI engines' fallbacks).

The port of sgnn_tpu/parallel/dp.py.  Reference: the GCN/GS/GAT *ALLMULTI
and *PCMULTI engines — the train nids split across the GPUs
(GCN_SAMPLE_ALL_MULTI.hpp:564-575), a sampler and stream per GPU, and an
NCCL AllReduce SUM of the gradients every step (Update :367-377 →
NCCL_Communicator::AllReduce, cuda/ntsCUDA.hpp:160).

The JAX package runs every device in one program (`shard_map`); here each
rank is a process with its own copy of the base trainer.  Every rank draws
the epoch's permutation from the base sampler's generator, identical on
every rank, and takes shard `rank` of `np.array_split`; it samples its
shard with its own HostSampler (seed cfg.seed + 101·rank + 1, so its numpy
draws are those of the JAX package's device `rank`), one step ahead on a
worker thread.  Each step's gradients are summed over the ranks between
the backward and the update (`SampleTrainer.grad_reduce`), so parameters
and optimizer state stay replicated; batch-norm statistics stay per rank,
as under `shard_map`.  The loss is averaged over the ranks and the
accuracy summed as (correct, count), as the JAX package reports them.
"""

from __future__ import annotations

import dataclasses
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..sampler.host import HostSampler
from ..train.checkpoint import decode_np_rng, np_rng_state
from ..train.guard import check_finite_loss
from ..train.trainer import SampleTrainer, TrainReport
from ..utils.logging import get_logger
from .mesh import DataGroup, make_group

log = get_logger("sgnn.dp")

# a rank's own streams: rank r > 0 seeds its dropout (and, on the device
# sampler, its sampling) generator at the base seed + RANK_SEED_STRIDE·r;
# rank 0 keeps the base trainer's own
RANK_SEED_STRIDE = 101


def rank_generator(base: SampleTrainer, seed: int, rank: int
                   ) -> torch.Generator:
    return torch.Generator(device=base.device).manual_seed(
        seed + RANK_SEED_STRIDE * rank)


class DataParallelWrapper:
    """What the two data-parallel trainers share: the group, the base
    trainer's gradient reduction and per-rank dropout, the cross-rank
    epoch summary, checkpoints through `.base` and the run loop."""

    def __init__(self, base: SampleTrainer,
                 group: Optional[DataGroup] = None) -> None:
        self.base = base
        self.group = group if group is not None else make_group(base.device)
        if self.group.device.type != base.device.type:
            raise ValueError(f"rank {self.group.rank} is on "
                             f"{self.group.device}, its trainer on "
                             f"{base.device}")
        self.rank, self.n_dev = self.group.rank, self.group.world_size
        self.timers = base.timers
        base.grad_reduce = self.group.reduce_grads
        if self.rank > 0:
            base.generator = rank_generator(base, base.cfg.seed + 1,
                                            self.rank)

    @property
    def cfg(self):
        return self.base.cfg

    @property
    def family(self) -> str:
        return self.base.family

    @property
    def params(self):
        return self.base.params

    def _summary(self, loss: float, correct: int, total: int, edges: int,
                 hits: int = 0, lookups: int = 0
                 ) -> Tuple[float, float, int, int, int]:
        """The epoch over all ranks: the loss averaged (each rank's mean of
        its steps, all ranks taking the same number of steps), correct and
        valid counts, edges and cache hits summed — one all_reduce."""
        t = torch.tensor([loss, correct, total, edges, hits, lookups],
                         dtype=torch.float64, device=self.group.device)
        loss, correct, total, edges, hits, lookups = \
            self.group.all_reduce_sum_(t).tolist()
        return (loss / self.n_dev, correct / max(total, 1), int(edges),
                int(hits), int(lookups))

    # ----------------------------------------------------------- checkpoint
    def _rank_streams(self) -> dict:
        """This rank's own random streams (its dropout generator here)."""
        return {"dropout_rng": self.base.generator.get_state()}

    def _set_rank_streams(self, streams: dict) -> None:
        self.base.generator.set_state(streams["dropout_rng"])

    def checkpoint_state(self) -> dict:
        """The base trainer's state, replicated over the ranks
        (sgnn_tpu/train/checkpoint.py:55-56), with every rank's own random
        streams gathered beside it, so that a resume draws on every rank
        what the uninterrupted run draws.  A collective: every rank calls
        it; `CheckpointManager` writes rank 0's."""
        state = self.base.checkpoint_state()
        every = [None] * self.n_dev
        # gathered as numpy arrays (pickled), kept as tensors
        # (`torch.load(weights_only=True)` reads tensors, not arrays)
        dist.all_gather_object(every, {k: v.numpy() for k, v in
                                       self._rank_streams().items()})
        state["rank_streams"] = [{k: torch.from_numpy(v) for k, v in
                                  streams.items()} for streams in every]
        return state

    def load_checkpoint_state(self, state: dict) -> None:
        """Every rank loads the replicated state, then its own streams (a
        checkpoint of another rank count leaves a rank past 0 with its
        current ones)."""
        own = self._rank_streams()
        self.base.load_checkpoint_state(state)
        streams = state.get("rank_streams")
        if streams is not None and len(streams) == self.n_dev:
            self._set_rank_streams(streams[self.rank])
        elif self.rank > 0:
            self._set_rank_streams(own)

    # ---------------------------------------------------------------- loops
    def run(self, epochs: Optional[int] = None,
            eval_every: int = 1) -> TrainReport:
        """The sampled trainers' epoch loop and report; every rank runs it
        and reaches the same collectives in the same order."""
        base = self.base
        epochs = epochs if epochs is not None else base.cfg.epochs
        report = TrainReport([], [], [], [], [], [], self.timers,
                             time_skip=base.cfg.time_skip)
        for ep in range(epochs):
            t0 = time.perf_counter()
            loss, tr_acc, edges = self.train_epoch()
            check_finite_loss(loss, ep, type(self).__name__)
            if base.device.type == "cuda":
                torch.cuda.synchronize(base.device)
            dt = time.perf_counter() - t0
            report.epoch_times.append(dt)
            report.losses.append(loss)
            report.train_acc.append(tr_acc)
            report.edges_per_epoch.append(edges)
            if (ep + 1) % eval_every == 0 or ep == epochs - 1:
                va = (self.evaluate(base.val_nids)
                      if base.val_nids.size else 0.0)
                te = (self.evaluate(base.test_nids)
                      if base.test_nids.size else 0.0)
            else:
                va = report.val_acc[-1] if report.val_acc else 0.0
                te = report.test_acc[-1] if report.test_acc else 0.0
            report.val_acc.append(va)
            report.test_acc.append(te)
            if self.rank == 0:
                log.info("dp epoch %d (%d ranks): loss %.5f train %.4f val "
                         "%.4f test %.4f time %.3fs edges %d", ep,
                         self.n_dev, loss, tr_acc, va, te, dt, edges)
        return report


class DataParallelTrainer(DataParallelWrapper):
    """A SampleTrainer (or CachedSampleTrainer with one global hot set:
    the *PCMULTI composition) run data-parallel over the group's ranks."""

    def __init__(self, base: SampleTrainer,
                 group: Optional[DataGroup] = None) -> None:
        super().__init__(base, group)
        # the *PCMULTI composition: one global hot set, refreshed at each
        # super-batch boundary from the replicated W0 on every rank
        self.cached = hasattr(base, "sb_caches")
        if self.cached and base.per_sb:
            raise ValueError("the data-parallel cached composition needs "
                             "one global hot set (per_sb=False)")
        s0 = base.sampler
        # a rank's batch = the chunk it actually trains (≤ BATCH_SIZE)
        shard = -(-len(base.train_nids) // self.n_dev)
        self.dev_batch = max(1, min(base.cfg.batch_size, shard))
        self.sampler = HostSampler(
            base.adj, fanouts=base.cfg.fanout, batch_size=self.dev_batch,
            weight_kind=s0.weight_kind, degree_mode=s0.degree_mode,
            exact=s0.exact, seed=base.cfg.seed + RANK_SEED_STRIDE * self.rank
            + 1, use_native=s0.use_native)
        self.cache_hits = 0
        self.cache_lookups = 0

    def _rank_batches(self, nids: np.ndarray):
        """This rank's uploaded batches of the epoch, sampled one step
        ahead on a worker thread (the sampler's state serialises its
        steps).  Every rank yields the same number of steps: a rank whose
        shard ran out trains a dummy batch with no valid label, and still
        joins the step's all_reduce — a rank that skipped it would leave
        the others waiting in the collective for ever."""
        base = self.base
        nids = base.sampler.rng.permutation(np.asarray(nids, np.int32))
        shards = np.array_split(nids, self.n_dev)
        bs = base.cfg.batch_size
        n_steps = max((len(s) + bs - 1) // bs for s in shards)
        mine = shards[self.rank]

        def make(step: int):
            seeds = mine[step * bs:(step + 1) * bs]
            dummy = seeds.size == 0
            if dummy:
                seeds = np.zeros(1, np.int32)
            return base._make_batch(seeds, self.sampler), dummy

        pool = ThreadPoolExecutor(max_workers=1)
        try:
            fut = pool.submit(make, 0) if n_steps else None
            for step in range(n_steps):
                item, dummy = fut.result()
                if step + 1 < n_steps:
                    fut = pool.submit(make, step + 1)
                batch, nedges = base._upload(item)
                if dummy:
                    batch = dataclasses.replace(
                        batch, label_valid=torch.zeros_like(
                            batch.label_valid))
                    nedges = 0
                yield batch, nedges
        finally:
            pool.shutdown(wait=True, cancel_futures=True)

    def train_epoch(self) -> Tuple[float, float, int]:
        """One epoch over every rank → (mean loss, train accuracy, sampled
        edges), the same on every rank."""
        base = self.base
        losses, accs, edges = [], [], 0
        pipe = max(base.cfg.pipeline_num, 1)
        if self.cached:
            base._cache_active = True
        try:
            for i, (batch, nedges) in enumerate(
                    self._rank_batches(base.train_nids)):
                cache_emb = None
                if self.cached:
                    # super-batch boundary: one weight version a
                    # super-batch, as the single-device orchestrator
                    if i % pipe == 0:
                        base._refresh_cache()
                    cache_emb = base.cache.cache_emb
                with self.timers.phase("dp_train_step"):
                    loss, acc = base.train_step(batch, cache_emb)
                losses.append(loss)
                accs.append(acc)
                edges += nedges
        finally:
            if self.cached:
                base._cache_active = False
        if not losses:
            return 0.0, 0.0, 0
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        hits = getattr(base, "cache_hits", 0)
        lookups = getattr(base, "cache_lookups", 0)
        loss, acc, edges, self.cache_hits, self.cache_lookups = \
            self._summary(float(torch.stack(losses).mean()), correct, total,
                          edges, hits, lookups)
        return loss, acc, edges

    def _rank_streams(self) -> dict:
        return {**super()._rank_streams(),
                "host_rng": np_rng_state(self.sampler.rng)}

    def _set_rank_streams(self, streams: dict) -> None:
        super()._set_rank_streams(streams)
        decode_np_rng(self.sampler.rng, streams["host_rng"])

    @property
    def cache_hit_rate(self) -> float:
        """Cached bottom-hop destinations over valid ones, every rank's."""
        return self.cache_hits / max(self.cache_lookups, 1)

    def evaluate(self, nids: np.ndarray) -> float:
        """The base trainer's evaluation: every rank draws the same blocks
        from the base sampler, so every rank reports the same accuracy."""
        return self.base.evaluate(nids)
