"""Data-parallel training on the device sampler (*ALLMULTI, *PCMULTI).

The port of sgnn_tpu/parallel/dp_device.py.  Reference: the *ALLMULTI
engines — a sampler per GPU and an NCCL AllReduce of the gradients
(GCN_SAMPLE_ALL_MULTI.hpp); the *PCMULTI engines add the PD-cache, shared
by every GPU (GCN_SAMPLE_PC_MULTI, core/ntsDataloador.hpp:735-762).

Each rank runs the device trainer's whole pipeline (sample → gather →
forward/backward, train/device_trainer.py's per-step loop) on its own seed
shard with the replicated graph and features; the step's gradients are
summed over the ranks before the replicated Adam update.  The JAX package
runs the epoch as one `lax.scan` under `shard_map`; here it is the same
eager loop on every rank, one all_reduce a step, no host sync inside the
epoch.

SHARD_FEATURES:1 row-shards the feature matrix over the ranks (each holds
ceil(V_pad / n) rows) and drops the replicated copy: every step fetches
its sampled rows from their owners (parallel/sharded_features.py), int8
rows dequantized after the fetch; evaluation then runs data-parallel too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..sampler.blocks import SampledBatch, pad_to
from ..train.device_trainer import DeviceSampleTrainer
from .dp import DataParallelWrapper, rank_generator
from .mesh import DataGroup
from .sharded_features import fetch_feature_rows


class DeviceDataParallelTrainer(DataParallelWrapper):
    """A DeviceSampleTrainer run data-parallel over the group's ranks.

    Rank r samples with its own torch.Generator; rank 0's is the base
    trainer's own, so a one-rank group trains bit for bit as the
    single-device engine does (same seeds, same draws, the all_reduce of
    one rank an identity).  The seeds of a step are padded to the largest
    chunk of any rank, and the source bounds follow that chunk
    (`compute_src_pads(chunk_max)`), not BATCH_SIZE."""

    def __init__(self, base: DeviceSampleTrainer,
                 group: Optional[DataGroup] = None,
                 shard_features: bool = False) -> None:
        super().__init__(base, group)
        if self.rank > 0:
            base.sample_generator = rank_generator(base, base.cfg.seed + 17,
                                                   self.rank)
        self.shard_features = shard_features
        self.feat_local: Optional[torch.Tensor] = None
        if shard_features:
            vpad, f_dim = base.dev_features.shape
            rows = -(-vpad // self.n_dev)
            lo = self.rank * rows
            local = torch.zeros((rows, f_dim), dtype=base.dev_features.dtype,
                                device=base.device)
            take = base.dev_features[lo:lo + rows]
            local[: take.shape[0]] = take
            self.feat_rows = rows
            self.feat_local = local
            # train and eval both run through the shards from here on
            base.dev_features = None
            base.fetch_x0 = self._fetch_sharded_x0

    def _rank_streams(self) -> dict:
        return {**super()._rank_streams(),
                "sample_rng": self.base.sample_generator.get_state()}

    def _set_rank_streams(self, streams: dict) -> None:
        super()._set_rank_streams(streams)
        self.base.sample_generator.set_state(streams["sample_rng"])

    def _fetch_sharded_x0(self, batch: SampledBatch) -> SampledBatch:
        """x0 from the row-sharded features: the owners' rows fetched over
        the group, dequantized (int8) after the fetch, invalid rows
        zeroed."""
        b0 = batch.blocks[0]
        nbytes = b0.srcs.numel() * self.feat_local.shape[1] \
            * self.feat_local.element_size()
        with self.group.timed_region("feature_fetch", nbytes):
            rows = fetch_feature_rows(self.feat_local, b0.srcs, self.group)
        rows = self.base.dequantize(rows)
        x0 = torch.where(b0.src_valid[:, None], rows,
                         torch.zeros((), dtype=rows.dtype,
                                     device=rows.device))
        return dataclasses.replace(batch, x0=x0)

    # ------------------------------------------------------------- seeds
    def _shard_seed_arrays(self, nids: np.ndarray):
        """This rank's padded seeds and valid flags ([n_steps, seed_pad]
        each) and the source bounds for the largest chunk of any rank
        (sgnn_tpu/parallel/dp_device.py:167-192).  Every rank takes
        n_steps, the longest shard's: a shorter shard pads its last steps
        with no valid seed and still joins their all_reduce."""
        base = self.base
        shards = np.array_split(np.asarray(nids, np.int32), self.n_dev)
        bs = base.cfg.batch_size
        n_steps = max((len(s) + bs - 1) // bs for s in shards)
        chunk_max = max(min(bs, len(s)) for s in shards)
        seed_pad = pad_to(max(chunk_max, 1), 128)
        src_pads = (base.src_pads if seed_pad == base.seed_pad
                    else base.compute_src_pads(chunk_max))
        mine = shards[self.rank]
        seeds = np.zeros((n_steps, seed_pad), np.int32)
        valid = np.zeros((n_steps, seed_pad), bool)
        for t in range(n_steps):
            chunk = mine[t * bs:(t + 1) * bs]
            seeds[t, : chunk.size] = chunk
            valid[t, : chunk.size] = True
        return seeds, valid, src_pads

    def _rank_steps(self, seeds: np.ndarray, valid: np.ndarray):
        dev = self.base.device
        for s, v in zip(seeds, valid):
            yield (torch.from_numpy(s).to(dev), torch.from_numpy(v).to(dev))

    def _with_pads(self, src_pads, fn):
        base = self.base
        saved, base.src_pads = base.src_pads, src_pads
        try:
            return fn()
        finally:
            base.src_pads = saved

    # ---------------------------------------------------------------- loops
    def train_epoch(self) -> Tuple[float, float, int]:
        """One epoch over every rank → (mean loss, train accuracy, sampled
        edges), the same on every rank; the base trainer's per-step
        times, losses and overflow are this rank's."""
        base = self.base
        seeds, valid, src_pads = self._shard_seed_arrays(base._train_order())
        loss, correct, total, edges = self._with_pads(
            src_pads, lambda: base._train_steps(self._rank_steps(seeds,
                                                                 valid)))
        hits = getattr(base, "cache_hits", 0)
        lookups = getattr(base, "cache_lookups", 0)
        loss, acc, edges, hits, lookups = self._summary(
            loss, correct, total, edges, hits, lookups)
        if hasattr(base, "cache_hits"):
            base.cache_hits, base.cache_lookups = hits, lookups
        return loss, acc, edges

    @torch.no_grad()
    def evaluate(self, nids: np.ndarray) -> float:
        """Replicated features: the base trainer's evaluation (rank 0's,
        sent to every rank).  Row-sharded features: each rank evaluates its
        shard through the fetch, the counts summed over the ranks
        (sgnn_tpu/parallel/dp_device.py:222-287)."""
        base = self.base
        nids = np.asarray(nids, np.int32)
        if not self.shard_features:
            if self.n_dev == 1:
                return base.evaluate(nids)
            acc = torch.zeros(1, dtype=torch.float64,
                              device=self.group.device)
            if self.rank == 0:
                acc[0] = base.evaluate(nids)
            return float(self.group.broadcast_(acc)[0])
        if nids.size == 0:
            return 0.0
        seeds, valid, src_pads = self._shard_seed_arrays(nids)

        def counts():
            got = torch.zeros(2, dtype=torch.int64, device=base.device)
            for s, v in self._rank_steps(seeds, valid):
                with self.timers.phase("device_eval"):
                    got += base.eval_step(base.sample(s, v)).to(torch.int64)
            return got

        got = self._with_pads(src_pads, counts)
        correct, total = self.group.all_reduce_sum_(got.double()).tolist()
        return correct / max(total, 1)


class DeviceCachedDataParallelTrainer(DeviceDataParallelTrainer):
    """*PCMULTI on the device sampler: a DeviceCachedSampleTrainer built
    with one global hot set (`per_sb=False`) run data-parallel.  Its
    parameters are replicated, so every rank recomputes the identical
    refresh `agg @ W0` at each super-batch boundary — a [C, F]·[F, H]
    product, cheaper than a collective to share it — and samples with the
    replicated omit map; the epoch's shuffle is the base trainer's
    super-batch-stable one, and hits and lookups are summed over the
    ranks."""

    def __init__(self, base, group: Optional[DataGroup] = None,
                 shard_features: bool = False) -> None:
        if len(base.sb_caches) != 1:
            raise ValueError("the data-parallel cached trainer needs one "
                             "global hot set (per_sb=False)")
        super().__init__(base, group, shard_features)

    @property
    def cache_hit_rate(self) -> float:
        return self.base.cache_hit_rate
