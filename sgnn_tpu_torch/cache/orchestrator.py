"""PD-cache training over the host sampler: super-batches and hot-vertex reuse.

The port of sgnn_tpu/cache/orchestrator.py.  Reference flow
(GCN_SAMPLE_PD_CACHE_impl::run, toolkits/GCN_SAMPLE_PD_CACHE.hpp:671-871;
SURVEY.md §3.2): pre-sample hotness → plan super-batches (batch ·
pipeline_num) → a CPU helper computes the hot vertices' bottom layer with
a staleness-bounded W per super-batch while the trainer runs a
cache-omitting sampler and splices the cached rows into the layer-0
activations.

Here each super-batch plan's PushDown aggregate is computed once at build
(K2 on the card over resident features, numpy over host ones); at each
super-batch boundary the consumer installs that plan and refreshes its
rows with the newest W0 published to the StalenessQueue (`agg @ W0`, no
gradient); the prefetch thread samples ahead with each batch's OWN plan's
omit map (`SampleTrainer._producer_sb`), so a batch always meets the cache rows of the
plan it was sampled under.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import RunConfig
from ..data.dataset import MASK_TRAIN, Dataset
from ..sampler.blocks import WeightKind
from ..sampler.host import HostSampler
from ..train.trainer import SampleTrainer, _HostItem
from ..utils.logging import get_logger
from .embedding_cache import EmbeddingCache, StalenessQueue
from .hotness import (
    presample_hotness, presample_hotness_per_sb, super_batch_stable_shuffle,
)

log = get_logger("sgnn.cache")

# without CACHE_RATE the JAX package caches this fraction of the vertices
DEFAULT_CACHE_RATE = 0.1


def check_cached_layers(cfg: RunConfig) -> None:
    """The cache holds LAYER-0 hidden rows that layer 1 consumes: a
    one-layer model would train omitted seeds on zero rows."""
    if len(cfg.layer_sizes) < 3:
        raise ValueError(
            "cached engines need >= 2 layers (LAYERS with a hidden dim): "
            "the embedding cache holds layer-0 hidden outputs consumed by "
            "layer 1 — use the non-cached engine for single-layer models")


def stacked_aggregate_bytes(cfg: RunConfig, dataset: Dataset,
                            per_sb: Optional[bool] = None) -> int:
    """Device bytes of a cached trainer's PushDown aggregates, n_sb plans
    of [C, F] f32, resident for the whole run (n_sb from the whole train
    set: an upper bound when BATCH_TYPE drops seeds; 1 with
    `per_sb=False`, the one global plan)."""
    v, f_dim = dataset.features.shape
    rate = cfg.cache_rate if cfg.cache_rate > 0 else DEFAULT_CACHE_RATE
    sb_size = cfg.batch_size * max(cfg.pipeline_num, 1)
    n_sb = (1 if per_sb is False else max(
        -(-len(dataset.nids_with_mask(MASK_TRAIN)) // sb_size), 1))
    return n_sb * int(v * rate) * f_dim * 4


def use_per_sb(per_sb: Optional[bool], n_train: int, sb_size: int) -> bool:
    """One plan per super-batch when the train set spans more than one
    super-batch, unless the caller asks for one global plan
    (`per_sb=False`: the data-parallel engines, whose ranks sample their
    shards concurrently, share one hot set)."""
    return per_sb is not False and n_train > sb_size


def build_plans(trainer, agg_kind: WeightKind, mean_style: str,
                super_batch_size: int, per_sb: bool,
                features) -> List[EmbeddingCache]:
    """The cache plans of a trainer: one per super-batch when `per_sb`
    (the trainers ask for that when the train set spans more than one
    super-batch), else one global plan, each with its
    one-time PushDown aggregate over `features` (a device tensor: K2; a
    host array: numpy).  The trainer's timers get the build's three
    phases: "presample", "cache_csr" and "cache_aggregate" (ending in a
    sync on the card, so it holds the kernels' time)."""
    cfg = trainer.cfg
    rate = cfg.cache_rate if cfg.cache_rate > 0 else DEFAULT_CACHE_RATE
    edge_file = cfg.edge_file or None
    with trainer.timers.phase("presample"):
        if per_sb:
            per_ids = presample_hotness_per_sb(
                trainer.adj, trainer.train_nids, cfg.fanout, rate,
                super_batch_size, edge_file=edge_file,
                batch_size=cfg.batch_size)
        else:
            per_ids = presample_hotness(
                trainer.adj, trainer.train_nids, cfg.fanout, rate,
                edge_file=edge_file, batch_size=cfg.batch_size)[None]
    with trainer.timers.phase("cache_csr"):
        caches = [EmbeddingCache.build(trainer.adj, ids, agg_kind,
                                       mean_style=mean_style,
                                       device=trainer.device)
                  for ids in per_ids]
    with trainer.timers.phase("cache_aggregate"):
        for c in caches:
            c.precompute_aggregate(features, trainer._feat_scale)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)
    return caches


class CachedSampleTrainer(SampleTrainer):
    """SampleTrainer + NeutronOrch hot-vertex embedding cache (host
    sampler; PD_REFRESH:host, PUSHDOWN on a host engine, and every cached
    engine whose features exceed the device)."""

    # this trainer IS the estimator-regime recommendation: the advisor
    # reports its numbers without the warning
    _advisor_remedied = True

    def __init__(
        self,
        cfg: RunConfig,
        dataset: Dataset,
        family: str = "gcn",
        weight_kind: WeightKind = WeightKind.GCN,
        degree_mode: str = "sampled",
        bias_correction: bool = False,
        adj=None,
        features_on_device: Optional[bool] = None,
        hbm_budget_bytes: Optional[int] = None,
        device=None,
        per_sb: Optional[bool] = None,
    ) -> None:
        check_cached_layers(cfg)
        self._per_sb_arg = per_sb   # read by the residency probe below
        super().__init__(
            cfg, dataset, family=family, weight_kind=weight_kind,
            degree_mode=degree_mode, bias_correction=bias_correction, adj=adj,
            features_on_device=features_on_device,
            hbm_budget_bytes=hbm_budget_bytes, device=device)
        self.super_batch_size = cfg.batch_size * max(cfg.pipeline_num, 1)
        agg_kind = weight_kind if family != "gat" else WeightKind.MEAN
        # the cache's weights must match the sampler's (global → plain mean)
        ms = "plain" if degree_mode == "global" else "hybrid"
        # one plan per super-batch, one global plan when a single
        # super-batch holds the whole train set or `per_sb=False`
        self.per_sb = use_per_sb(per_sb, len(self.train_nids),
                                 self.super_batch_size)
        # the aggregates run over the resident features on the device (K2),
        # else over the host store (int8 levels when quantized)
        if self.features_on_device:
            feat_src = self.dev_features
        elif self._host_q is not None:
            feat_src = self._host_q
        else:
            feat_src = np.asarray(dataset.features)
        self.sb_caches = build_plans(self, agg_kind, ms,
                                     self.super_batch_size, self.per_sb,
                                     feat_src)
        self.cache = self.sb_caches[0]   # the consumer's active plan
        self.w_queue = StalenessQueue()
        self.cache_hits = 0
        self.cache_lookups = 0
        self._counter_lock = threading.Lock()
        self._cache_active = False   # on for training batches only
        log.info("PD-cache: %d hot vertices (%.1f%%) x %d super-batch plans",
                 self.cache.num_cached,
                 100.0 * self.cache.num_cached / max(self.adj.num_vertices, 1),
                 len(self.sb_caches))

    def _resident_extra_bytes(self, cfg: RunConfig, dataset: Dataset) -> int:
        return stacked_aggregate_bytes(cfg, dataset, self._per_sb_arg)

    # ------------------------------------------------------------- batching
    def _make_batch(self, seeds: np.ndarray,
                    sampler: Optional[HostSampler] = None) -> _HostItem:
        """Producer side: with the cache on, sample under this batch's own
        super-batch plan's omit map (the producer runs ahead of the
        consumer), count hits, and gather the payload (ids only with
        resident features, the feature cache's misses, or full rows).
        `sampler` replaces `self.sampler` (a data-parallel rank's own
        stream)."""
        if not self._cache_active:
            return super()._make_batch(seeds, sampler)
        k = self._producer_sb()
        cache = self.sb_caches[k % len(self.sb_caches)]
        with self.timers.phase("sample"):
            hb = (sampler or self.sampler).sample(
                seeds, omit_map=cache.cache_map_host)
            b0, top = hb.blocks[0], hb.blocks[-1]
            slots = cache.cache_map_host[np.maximum(b0.seeds, 0)]
            mask = (slots >= 0) & b0.dst_valid
            with self._counter_lock:
                self.cache_hits += int(mask.sum())
                self.cache_lookups += int(b0.dst_valid.sum())
            if self.features_on_device:
                item = _HostItem(hb, np.zeros((1, 1), np.float32),
                                 np.zeros(top.seeds.shape[0], np.int32),
                                 top.dst_valid)
            elif self.feat_cache is not None:
                # the feature plan follows the same super-batch index
                item = self._gather_cold(hb, k)
            else:
                feats = (self._host_q if self._host_q is not None
                         else self.dataset.features)
                item = _HostItem(hb, *hb.payload(feats, self.dataset.labels))
        return item._replace(cache_mask=mask,
                             cache_slot=np.maximum(slots, 0).astype(np.int32))

    # ---------------------------------------------------------------- loops
    def _refresh_cache(self) -> None:
        """Super-batch boundary: publish W0 as it stands before this
        step's update, and refresh the active plan's rows with it."""
        with self.timers.phase("cache_refresh"):
            self.w_queue.push(self.params.weights[0])
            w0, version = self.w_queue.get()
            self.cache.refresh(w0, version)

    def train_epoch(self) -> Tuple[float, float, int]:
        losses, accs, edges = [], [], 0
        nids = super_batch_stable_shuffle(self.train_nids,
                                          self.super_batch_size,
                                          self.sampler.rng)
        self._cache_active = True
        self._produce_idx = 0
        # per-SB feature plans: the consumer installs batch i's plan (i //
        # pipeline_num) as it assembles the batch (`_fc_consume_advance`)
        self._fc_train_mode = True
        self._fc_consume_idx = 0
        pipe = max(self.cfg.pipeline_num, 1)
        try:
            for i, (batch, nedges) in enumerate(
                    self._batch_stream(nids, shuffle=False)):
                if i % pipe == 0:
                    # install this super-batch's plan (set_cache_index) and
                    # refresh it with the newest W (shared_W_queue push,
                    # GCN_SAMPLE_PD_CACHE.hpp:603-606)
                    self.cache = self.sb_caches[(i // pipe)
                                                % len(self.sb_caches)]
                    self._refresh_cache()
                with self.timers.phase("train_step"):
                    loss, acc = self.train_step(batch, self.cache.cache_emb)
                losses.append(loss)
                accs.append(acc)
                edges += nedges
        finally:
            self._cache_active = self._fc_train_mode = False
        if not losses:
            return 0.0, 0.0, 0
        mean_loss = float(torch.stack(losses).mean())
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        return mean_loss, correct / max(total, 1), edges

    @property
    def cache_hit_rate(self) -> float:
        return self.cache_hits / max(self.cache_lookups, 1)

    # ------------------------------------------------------------ checkpoint
    def checkpoint_state(self) -> dict:
        """+ the cache rows and the staleness queue's weight and version,
        so a resumed run's cache is exactly as stale as the uninterrupted
        run's."""
        st = super().checkpoint_state()
        hidden = self.cfg.layer_sizes[1]
        emb = self.cache.cache_emb
        st["cache_emb"] = (emb.detach().cpu() if emb is not None
                           else torch.zeros(self.cache.num_cached, hidden))
        w = self.w_queue._w
        st["w_queue_w"] = (w.cpu() if w is not None
                           else torch.zeros_like(self.params.weights[0],
                                                 device="cpu"))
        st["w_queue_version"] = int(self.w_queue.version)
        return st

    def load_checkpoint_state(self, state: dict) -> None:
        super().load_checkpoint_state(state)
        version = int(state["w_queue_version"])
        self.w_queue.version = version
        if version >= 0:
            self.w_queue._w = state["w_queue_w"].to(self.device)
            self.cache.cache_emb = state["cache_emb"].to(self.device)
            self.cache.version = version
