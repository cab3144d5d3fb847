"""Mini-batch GNN trainer: host sample → upload → eager train step.

The port of sgnn_tpu/train/trainer.py.  Reference: the engines'
run()/Train()/Forward() skeleton (e.g. GCN_SAMPLE_ALLGPU.hpp:268-400): a
per-epoch shuffle of the train nids, a pipeline of sample → H2D transfer →
forward/backward/update, per-split accuracy and phase timers.

The step is eager PyTorch: `model_forward` (K1 on the card), the masked
NLL, `loss.backward()`, then the reference Adam/SGD rule.  A one-deep
prefetch thread samples batch t+1 (numpy and the native sampler, no CUDA
call) while the card runs step t; the consumer uploads each batch itself,
so every CUDA operation is issued from one thread, in order, on the
current stream.  Losses and correct-counts stay on the device until the
end of the epoch: one host sync per epoch, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import full_f32_products, resolve_device
from ..cache.feature_cache import (
    FeatureCache, check_cold_pos, degree_ranked_hot_ids,
    feature_budget_bytes, hbm_feature_capacity, scatter_cold_rows,
)
from ..cache.hotness import presample_hotness_per_sb, super_batch_stable_shuffle
from ..config import RunConfig
from ..data.dataset import Dataset, MASK_TEST, MASK_TRAIN, MASK_VAL
from ..data.quant import quantize_columns
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads, init_model, model_forward
from ..nn.functional import masked_accuracy, nll_loss_masked
from ..nn.optim import make_optimizer
from ..sampler.blocks import SampledBatch, SampledBlock, WeightKind
from ..sampler.host import HostSampledBatch, HostSampler
from ..utils.logging import get_logger
from ..utils.timing import PhaseTimer, span
from .advisor import advise_estimator_regime
from .checkpoint import (
    decode_np_rng, load_opt_state, load_params, np_rng_state, opt_state_dict,
    params_state,
)
from .guard import check_finite_loss

log = get_logger("sgnn.train")

# features stay resident on the device below this many bytes (the JAX
# package's rule, sgnn_tpu/train/trainer.py:193-202)
RESIDENT_FEATURE_BYTES = 4 << 30


@dataclasses.dataclass
class TrainReport:
    epoch_times: List[float]
    train_acc: List[float]
    val_acc: List[float]
    test_acc: List[float]
    losses: List[float]
    edges_per_epoch: List[int]
    timers: PhaseTimer
    # TIME_SKIP: the first `time_skip` epochs (start-up) are left out of
    # the average epoch time
    time_skip: int = 1
    # REORDER: order[new_id] = old_id when `run_engine` renumbered the
    # vertices (graph/reorder.py): row new_id of any per-vertex result
    # belongs to the original vertex order[new_id]; None otherwise
    vertex_order: Optional[np.ndarray] = None

    @property
    def avg_epoch_time(self) -> float:
        n = len(self.epoch_times)
        if n == 0:
            return 0.0
        skip = min(n - 1, max(self.time_skip, 0))
        times = self.epoch_times[skip:]
        return float(np.mean(times)) if times else 0.0

    def to_dict(self) -> dict:
        """JSON-ready run record (the CLI's `--report-out`), with the JAX
        package's keys, which scripts/summarize_runs.py reads."""
        return {
            "epoch_times": [float(t) for t in self.epoch_times],
            "train_acc": [float(a) for a in self.train_acc],
            "val_acc": [float(a) for a in self.val_acc],
            "test_acc": [float(a) for a in self.test_acc],
            "losses": [float(x) for x in self.losses],
            "edges_per_epoch": [int(e) for e in self.edges_per_epoch],
            "time_skip": int(self.time_skip),
            "avg_epoch_time": self.avg_epoch_time,
            "phase_totals_s": {k: round(v, 6)
                               for k, v in self.timers.totals.items()},
            "phase_counts": dict(self.timers.counts),
        }


def check_host_batch(hb: HostSampledBatch) -> None:
    """Index bounds of a host batch, checked once in numpy before upload: a
    CUDA gather reads out of bounds where XLA clamps."""
    for i, b in enumerate(hb.blocks):
        if b.nbr.size and (int(b.nbr.min()) < 0
                           or int(b.nbr.max()) >= b.srcs.shape[0]):
            raise ValueError(f"block {i}: nbr outside [0, {b.srcs.shape[0]})")
        if b.seed_in_src.size and (int(b.seed_in_src.min()) < 0 or int(
                b.seed_in_src.max()) >= b.srcs.shape[0]):
            raise ValueError(f"block {i}: seed_in_src outside the src set")


def host_batch_to_device(hb: HostSampledBatch, x0, y, y_valid,
                         device=None) -> SampledBatch:
    """Upload a host batch (bounds-checked) as a SampledBatch on `device`."""
    dev = resolve_device(device)
    check_host_batch(hb)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    blocks = [SampledBlock(nbr=up(b.nbr), weight=up(b.weight),
                           srcs=up(b.srcs), seeds=up(b.seeds),
                           dst_valid=up(b.dst_valid),
                           src_valid=up(b.src_valid),
                           seed_in_src=up(b.seed_in_src))
              for b in hb.blocks]
    return SampledBatch(blocks=blocks, x0=up(x0),
                        labels=up(np.asarray(y, np.int64)),
                        label_valid=up(y_valid))


class StepOut(NamedTuple):
    loss: torch.Tensor        # scalar, detached
    logp: torch.Tensor        # [num_seed_pad, C], detached
    grads: List[torch.Tensor]  # one per GNNParams leaf


def loss_and_grads(params: GNNParams, family: str, batch: SampledBatch, *,
                   drop_rate: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   remat: bool = False, batch_norm: bool = False,
                   heads: int = 1,
                   cache_emb: Optional[torch.Tensor] = None) -> StepOut:
    """Forward, masked NLL and its gradient with respect to every
    parameter leaf: the differentiated part of a training step, on the
    batch's device.  `cache_emb` is the hot-vertex cache's layer-0 rows
    (`model_forward`)."""
    leaves = [p.detach().requires_grad_() for p in params.leaves()]
    with span("forward", batch.labels):
        logp = model_forward(params.replace_leaves(leaves), family, batch,
                             drop_rate=drop_rate, train=True,
                             generator=generator, remat=remat,
                             batch_norm=batch_norm, heads=heads,
                             cache_emb=cache_emb)
        loss = nll_loss_masked(logp, batch.labels, batch.label_valid)
    with span("backward", batch.labels):
        loss.backward()
    return StepOut(loss.detach(), logp.detach(), [p.grad for p in leaves])


class _HostItem(NamedTuple):
    """What the prefetch thread hands over: host arrays only.  `cold_pos`
    marks x0 as the feature cache's compacted miss rows; `cache_mask` and
    `cache_slot` are the embedding cache's bottom-hop merge."""

    hb: HostSampledBatch
    x0: np.ndarray
    y: np.ndarray
    y_valid: np.ndarray
    cold_pos: Optional[np.ndarray] = None
    cache_mask: Optional[np.ndarray] = None
    cache_slot: Optional[np.ndarray] = None


class SampleTrainer:
    """Single-device sampled training engine over the host sampler.

    FEATURE_DTYPE:int8 quantizes the features once (data/quant.py): on the
    device they stay int8 and each batch's gathered rows are dequantized
    there; in host mode (`features_on_device=False`) the batches ship int8
    rows, dequantized after the upload.  FEATURE_CACHE_RATE > 0 with the
    features off the device stages a partial feature cache
    (cache/feature_cache.py): the hottest rows on the device — by degree,
    or per super-batch under FEATURE_CACHE_PLAN:per_sb — and batches ship
    only their cache-miss rows.  `.estimator_advice` is the
    ESTIMATOR_ADVISOR's finding (train/advisor.py), None below its
    threshold.  `checkpoint_state` / `load_checkpoint_state` carry what a
    bit-identical resume needs (train/checkpoint.py)."""

    def __init__(
        self,
        cfg: RunConfig,
        dataset: Dataset,
        family: str = "gcn",
        weight_kind: WeightKind = WeightKind.GCN,
        degree_mode: str = "global",
        bias_correction: bool = False,
        adj: Optional[Adjacency] = None,
        features_on_device: Optional[bool] = None,
        hbm_budget_bytes: Optional[int] = None,
        device=None,
    ) -> None:
        if len(cfg.fanout) != len(cfg.layer_sizes) - 1:
            raise ValueError(
                f"FANOUT has {len(cfg.fanout)} hops but LAYERS defines "
                f"{len(cfg.layer_sizes) - 1} layers; they must match")
        # GAT computes its own attention: its blocks carry 1 on valid slots
        # whatever the caller asks (sgnn_tpu/train/trainer.py:161)
        if family == "gat":
            weight_kind = WeightKind.NONE
        self.device = resolve_device(device)
        full_f32_products(self.device)
        self.cfg = cfg
        self.dataset = dataset
        self.family = family
        self.adj = adj if adj is not None else Adjacency.from_edges(
            dataset.edges, dataset.num_vertices)
        self.train_nids = dataset.nids_with_mask(MASK_TRAIN)
        self.val_nids = dataset.nids_with_mask(MASK_VAL)
        self.test_nids = dataset.nids_with_mask(MASK_TEST)
        # BATCH_TYPE: dellow/delhigh drop the DEL_FRAC lowest/highest-degree
        # train seeds
        bt = cfg.batch_type.lower()
        if bt in ("dellow", "delhigh") and cfg.del_frac > 0:
            order = np.argsort(self.adj.in_degree[self.train_nids],
                               kind="stable")
            k = int(len(self.train_nids) * cfg.del_frac)
            keep = order[k:] if bt == "dellow" else order[: len(order) - k]
            self.train_nids = np.sort(self.train_nids[keep])
        # ESTIMATOR_ADVISOR: warn when one batch's bottom hop is expected to
        # reach most of the graph (train/advisor.py)
        self.estimator_advice = advise_estimator_regime(
            self.adj, cfg.fanout, cfg.batch_size, len(self.train_nids),
            mode=cfg.estimator_advisor,
            remedied=getattr(type(self), "_advisor_remedied", False),
            context=type(self).__name__)
        self.sampler = HostSampler(
            self.adj, fanouts=cfg.fanout, batch_size=cfg.batch_size,
            weight_kind=weight_kind, degree_mode=degree_mode, seed=cfg.seed)
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        # FEATURE_DTYPE ("" follows DTYPE): int8 stores per-column quantized
        # features (data/quant.py), 4x the f32 rows per byte of device
        # memory; gathered rows are dequantized on the device
        fd = (cfg.feature_dtype or cfg.dtype).lower()
        if fd not in ("float32", "bfloat16", "int8"):
            raise ValueError(f"FEATURE_DTYPE must be float32|bfloat16|int8, "
                             f"got {fd!r}")
        self.feature_int8 = fd == "int8"
        if hbm_budget_bytes is None and cfg.hbm_budget > 0:
            hbm_budget_bytes = cfg.hbm_budget
        store_dtype = {"int8": torch.int8,
                       "bfloat16": torch.bfloat16}.get(fd, torch.float32)
        if features_on_device is None:
            limit = (hbm_budget_bytes if hbm_budget_bytes is not None
                     else RESIDENT_FEATURE_BYTES)
            features_on_device = (
                dataset.features is not None
                and dataset.features.shape[0] * dataset.features.shape[1]
                * store_dtype.itemsize
                < limit - self._resident_extra_bytes(cfg, dataset))
        self.features_on_device = features_on_device
        # int8: quantized once on the host; `_feat_scale` is the [F] scale
        # on the device, `_host_q` the int8 rows host mode ships (1 byte an
        # element over the link)
        self._feat_scale = None
        self._host_q = None
        if self.feature_int8:
            q, scale = quantize_columns(dataset.features)
            self._feat_scale = torch.from_numpy(scale).to(self.device)
            if not features_on_device:
                self._host_q = q
        if features_on_device:
            feats = q if self.feature_int8 else np.ascontiguousarray(
                dataset.features)
            self.dev_features = torch.from_numpy(feats).to(self.device,
                                                           store_dtype)
            self.dev_labels = torch.from_numpy(
                dataset.labels.astype(np.int64)).to(self.device)
        else:
            self.dev_features = None
            self.dev_labels = None
        self._init_feature_cache(hbm_budget_bytes)
        self.params = init_model(cfg.seed, family, cfg.layer_sizes,
                                 device=self.device, heads=cfg.heads,
                                 gat_variant=cfg.gat_variant)
        check_heads(self.params, family, cfg.heads)
        # OPTIMIZER cfg key picks Adam (default) or the reference's SGD rule
        self.optimizer = make_optimizer(cfg, bias_correction)
        self.opt_state = self.optimizer.init(self.params.leaves())
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.timers = PhaseTimer()
        # gradients → grad_reduce → optimizer (None: this device's alone)
        self.grad_reduce: Optional[Callable[[List[torch.Tensor]],
                                            List[torch.Tensor]]] = None

    def _resident_extra_bytes(self, cfg: RunConfig, dataset: Dataset) -> int:
        """Device bytes a subclass keeps resident beside the features for
        the whole run, counted where residency is decided."""
        return 0

    # ------------------------------------------------ partial feature cache
    def _init_feature_cache(self, hbm_budget_bytes: Optional[int]) -> None:
        """FEATURE_CACHE_RATE with the features off the device (the JAX
        package's sgnn_tpu/train/trainer.py:223-310): as many of the
        hottest rows as the rate asks for and the capacity probe allows
        (`hbm_feature_capacity`), staged once by degree, or under
        FEATURE_CACHE_PLAN:per_sb one plan per super-batch from the
        hotness presample, only the active plan's rows on the device.
        Producer and consumer count batches apart (the prefetch thread
        samples ahead): the producer gathers each batch's misses under its
        own super-batch's slot map, the consumer installs that plan before
        the batch is assembled."""
        self.feat_cache: Optional[FeatureCache] = None
        self._fc_sb_caches: Optional[List[FeatureCache]] = None
        self._fc_sb_size = 0
        self._fc_dev_sb = 0
        self._produce_idx = 0   # the producer's batch counter (per epoch)
        self._fc_consume_idx = 0
        self._fc_train_mode = False
        cfg, dataset = self.cfg, self.dataset
        if self.features_on_device or cfg.feature_cache_rate <= 0:
            return
        # int8: hot rows stay int8 on the device and misses ship as int8;
        # otherwise rows are staged in the compute dtype
        self._fc_host_store = (self._host_q if self._host_q is not None
                               else dataset.features)
        self._fc_store_dtype = (None if self._host_q is not None
                                else self.compute_dtype)
        itemsize = (1 if self.feature_int8
                    else self.compute_dtype.itemsize)
        # the staged rows share the budget with what else stays resident
        # (a cached trainer's stacked aggregates) — a deliberate difference
        # from the JAX package, whose probe counts the features alone
        budget = (hbm_budget_bytes if hbm_budget_bytes is not None
                  else feature_budget_bytes(self.device))
        cap = hbm_feature_capacity(
            dataset.features.shape[1], itemsize,
            budget_bytes=max(budget - self._resident_extra_bytes(cfg, dataset),
                             0),
            device=self.device)
        rows = min(int(cfg.feature_cache_rate * dataset.num_vertices), cap)
        plan = (cfg.feature_cache_plan or "global").lower()
        sb_size = cfg.batch_size * max(cfg.pipeline_num, 1)
        if plan == "per_sb" and rows > 0 and len(self.train_nids) > sb_size:
            per = presample_hotness_per_sb(
                self.adj, self.train_nids, cfg.fanout,
                min(1.0, (rows + 0.5) / dataset.num_vertices), sb_size,
                edge_file=cfg.edge_file or None,
                batch_size=cfg.batch_size)[:, :rows]
            self._fc_sb_caches = [
                FeatureCache.build(self._fc_host_store, ids,
                                   dtype=self._fc_store_dtype, upload=False,
                                   device=self.device) for ids in per]
            self._fc_sb_size = sb_size
            self.feat_cache = self._fc_sb_caches[0]
            self.feat_cache.upload(self._fc_host_store, self._fc_store_dtype)
            staged = per.shape[1]
        else:
            hot = degree_ranked_hot_ids(self.adj, rows)
            self.feat_cache = FeatureCache.build(
                self._fc_host_store, hot, dtype=self._fc_store_dtype,
                device=self.device)
            staged = hot.size
        log.info("feature cache: %d/%d rows (%.1f%%) staged on the device "
                 "(capacity probe allowed %d, plan %s%s)", staged,
                 dataset.num_vertices,
                 100.0 * staged / max(dataset.num_vertices, 1), cap, plan,
                 f" x {len(self._fc_sb_caches)} SBs"
                 if self._fc_sb_caches else "")

    def _producer_sb(self) -> int:
        """Producer side: the super-batch of the batch being made (its
        index in the epoch // PIPELINE_NUM), advancing the producer's
        batch counter; the epoch loop resets it."""
        k = self._produce_idx // max(self.cfg.pipeline_num, 1)
        self._produce_idx += 1
        return k

    def _fc_producer_cache(self, sb: int) -> FeatureCache:
        """The FeatureCache whose host slot map a batch of super-batch `sb`
        gathers under (the one global plan outside per-SB training)."""
        if self._fc_sb_caches is None or not self._fc_train_mode:
            return self.feat_cache
        return self._fc_sb_caches[min(sb, len(self._fc_sb_caches) - 1)]

    def _fc_consume_advance(self) -> None:
        """Consumer side: before assembling the next batch, install the
        super-batch plan it was gathered under."""
        if self._fc_sb_caches is None or not self._fc_train_mode:
            return
        k = (self._fc_consume_idx * self.cfg.batch_size) // self._fc_sb_size
        self._fc_consume_idx += 1
        self._fc_install_sb(min(k, len(self._fc_sb_caches) - 1))

    def _fc_install_sb(self, k: int) -> None:
        """Make plan k's rows the resident ones, the previous plan's
        released first (one [C, F] set on the device at a time)."""
        if k == self._fc_dev_sb and self._fc_sb_caches[k].dev_hot is not None:
            return
        prev = self._fc_sb_caches[self._fc_dev_sb]
        prev.dev_hot = None
        prev.dev_slot_map = None
        with self.timers.phase("cache_refresh"):
            self._fc_sb_caches[k].upload(self._fc_host_store,
                                         self._fc_store_dtype)
        self.feat_cache = self._fc_sb_caches[k]
        self._fc_dev_sb = k

    @property
    def feature_cache_stats(self) -> Tuple[float, int, int]:
        """(hit rate, bytes shipped, bytes full shipping would send) over
        every feature-cache plan."""
        caches = (self._fc_sb_caches if self._fc_sb_caches is not None
                  else ([self.feat_cache] if self.feat_cache else []))
        hits = sum(c.hits for c in caches)
        misses = sum(c.misses for c in caches)
        return (hits / max(hits + misses, 1),
                sum(c.bytes_shipped for c in caches),
                sum(c.bytes_full for c in caches))

    def _gather_cold(self, hb: HostSampledBatch, sb: int) -> _HostItem:
        """Producer side, feature-cache mode: the bottom hop's cache-miss
        rows of a batch of super-batch `sb`, compacted, and the seeds'
        labels."""
        b0, top = hb.blocks[0], hb.blocks[-1]
        fcache = self._fc_producer_cache(sb)
        x0, cold_pos = fcache.gather_cold_compact(self._fc_host_store,
                                                  b0.srcs, b0.src_valid)
        y = self.dataset.labels[np.maximum(top.seeds, 0)].astype(np.int32)
        return _HostItem(hb, x0, y, top.dst_valid, cold_pos=cold_pos)

    def _assemble_cold(self, batch: SampledBatch) -> SampledBatch:
        """Consumer side, feature-cache mode: the compacted miss rows
        scattered onto the bottom source axis at `batch.cold_pos`, the
        resident hot rows laid over them, then dequantized (the JAX
        package's `_materialize`)."""
        b0 = batch.blocks[0]
        fc = self.feat_cache
        x0 = scatter_cold_rows(batch.x0.to(fc.dev_hot.dtype), batch.cold_pos,
                               b0.srcs.shape[0])
        x0 = fc.merge_device(x0, b0.srcs, b0.src_valid)
        return dataclasses.replace(batch, x0=self.dequantize(x0),
                                   cold_pos=None)

    # ----------------------------------------------------------- checkpoint
    def checkpoint_state(self) -> dict:
        """Everything a bit-identical resume needs (train/checkpoint.py):
        parameters, optimizer state, the dropout generator and the host
        sampler's numpy RNG, which also draws the epoch permutations."""
        return {"params": params_state(self.params),
                "opt_state": opt_state_dict(self.opt_state),
                "dropout_rng": self.generator.get_state(),
                "host_rng": np_rng_state(self.sampler.rng)}

    def load_checkpoint_state(self, state: dict) -> None:
        self.params = load_params(state["params"], self.params)
        self.opt_state = load_opt_state(state["opt_state"], self.opt_state)
        self.generator.set_state(state["dropout_rng"])
        decode_np_rng(self.sampler.rng, state["host_rng"])

    def dequantize(self, rows: torch.Tensor) -> torch.Tensor:
        """Feature rows in the compute dtype: int8 rows times the
        per-column scales, in the compute dtype as the JAX package's
        `_dequant`; other rows cast."""
        if rows.dtype != torch.int8:
            return rows.to(self.compute_dtype)
        return (rows.to(self.compute_dtype)
                * self._feat_scale.to(self.compute_dtype))

    # --------------------------------------------------------------- steps
    def train_step(self, batch: SampledBatch,
                   cache_emb: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One forward/backward/update on `batch` (with the embedding
        cache's rows `cache_emb`, if any); returns the loss and the
        (correct, valid) counts as device tensors.  Between the gradients
        and the update, `grad_reduce` (set by a data-parallel wrapper,
        parallel/dp.py) sums them over the ranks; a single trainer has
        none."""
        out = loss_and_grads(self.params, self.family, batch,
                             drop_rate=self.cfg.drop_rate,
                             generator=self.generator, remat=self.cfg.remat,
                             batch_norm=self.cfg.batch_norm,
                             heads=self.cfg.heads, cache_emb=cache_emb)
        grads = (out.grads if self.grad_reduce is None
                 else self.grad_reduce(out.grads))
        with span("update", self.device):
            new, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params.leaves())
            self.params = self.params.replace_leaves(new)
            return out.loss, masked_accuracy(out.logp, batch.labels,
                                             batch.label_valid)

    @torch.no_grad()
    def eval_step(self, batch: SampledBatch) -> torch.Tensor:
        logp = model_forward(self.params, self.family, batch, train=False,
                             batch_norm=self.cfg.batch_norm,
                             heads=self.cfg.heads)
        return masked_accuracy(logp, batch.labels, batch.label_valid)

    # ------------------------------------------------------------- batching
    def _make_batch(self, seeds: np.ndarray,
                    sampler: Optional[HostSampler] = None) -> _HostItem:
        """Producer side: sample and gather the host payload (no CUDA).
        `sampler` replaces `self.sampler` (a data-parallel rank's own
        stream, parallel/dp.py)."""
        with self.timers.phase("sample"):
            hb = (sampler or self.sampler).sample(seeds)
            if self.features_on_device:
                # x0/labels are gathered on the device; ship ids only
                top = hb.blocks[-1]
                return _HostItem(hb, np.zeros((1, 1), np.float32),
                                 np.zeros(top.seeds.shape[0], np.int32),
                                 top.dst_valid)
            if self.feat_cache is not None:
                return self._gather_cold(hb, self._producer_sb())
            feats = (self._host_q if self._host_q is not None
                     else self.dataset.features)
            return _HostItem(hb, *hb.payload(feats, self.dataset.labels))

    def _upload(self, item: _HostItem) -> Tuple[SampledBatch, int]:
        """Consumer side: upload, and gather x0/labels on the device when
        the features are resident there (or assemble x0 from the feature
        cache)."""
        with self.timers.phase("transfer"):
            batch = host_batch_to_device(item.hb, item.x0, item.y,
                                         item.y_valid, self.device)
            if item.cache_mask is not None:
                batch = dataclasses.replace(
                    batch,
                    cache_mask=torch.from_numpy(item.cache_mask).to(
                        self.device),
                    cache_slot=torch.from_numpy(item.cache_slot).to(
                        self.device))
            if item.cold_pos is not None:
                check_cold_pos(item.cold_pos, item.hb.blocks[0].srcs.shape[0])
                batch = dataclasses.replace(batch, cold_pos=torch.from_numpy(
                    item.cold_pos).to(self.device))
                self._fc_consume_advance()
                batch = self._assemble_cold(batch)
            elif self.features_on_device:
                b0, top = batch.blocks[0], batch.blocks[-1]
                rows = self.dequantize(
                    self.dev_features.index_select(0, b0.srcs.long()))
                x0 = torch.where(b0.src_valid[:, None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device))
                batch = dataclasses.replace(
                    batch, x0=x0, labels=self.dev_labels[top.seeds.long()])
            else:
                batch = dataclasses.replace(
                    batch, x0=self.dequantize(batch.x0))
        return batch, item.hb.num_valid_edges()

    def _batch_stream(self, nids: np.ndarray, shuffle: bool):
        """Prefetching iterator: the producer thread samples batch t+1 while
        the card runs step t; a producer error is re-raised here, and a
        consumer that stops early stops the producer."""
        q: "queue.Queue" = queue.Queue(maxsize=max(2, self.cfg.pipeline_num))
        seed_list = list(self.sampler.epoch_seed_batches(nids, shuffle))
        stop = threading.Event()

        def producer():
            try:
                for seeds in seed_list:
                    if stop.is_set():
                        return
                    q.put(self._make_batch(seeds))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                q.put(exc)
            else:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._upload(item)
        finally:
            stop.set()
            while t.is_alive():  # unblock a producer waiting on a full queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()

    # ---------------------------------------------------------------- loops
    def _epoch_order(self, nids: np.ndarray) -> np.ndarray:
        """Seed ordering per BATCH_TYPE: shuffle|sequence|random(+replace)."""
        bt = self.cfg.batch_type.lower()
        if bt == "sequence":
            return nids
        if bt == "random":
            return self.sampler.rng.choice(nids, size=len(nids), replace=True)
        return self.sampler.rng.permutation(nids)

    def train_epoch(self) -> Tuple[float, float, int]:
        """One epoch over the train nids → (mean loss, train acc, edges)."""
        losses, accs, edges = [], [], 0
        if self._fc_sb_caches is not None:
            # per-SB feature plans need stable super-batch membership
            # (BATCH_TYPE sequence has it by construction) and counters
            # from zero
            order = (self.train_nids
                     if self.cfg.batch_type.lower() == "sequence"
                     else super_batch_stable_shuffle(
                         self.train_nids, self._fc_sb_size,
                         self.sampler.rng))
            self._fc_train_mode = True
            self._produce_idx = self._fc_consume_idx = 0
        else:
            order = self._epoch_order(self.train_nids)
        try:
            for batch, nedges in self._batch_stream(order, shuffle=False):
                with self.timers.phase("train_step"):
                    loss, acc = self.train_step(batch)
                losses.append(loss)
                accs.append(acc)
                edges += nedges
        finally:
            self._fc_train_mode = False
        if not losses:
            return 0.0, 0.0, 0
        mean_loss = float(torch.stack(losses).mean())
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        return mean_loss, correct / max(total, 1), edges

    def evaluate(self, nids: np.ndarray) -> float:
        accs = []
        for batch, _ in self._batch_stream(nids, shuffle=False):
            with self.timers.phase("eval_step"):
                accs.append(self.eval_step(batch))
        if not accs:
            return 0.0
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        return correct / max(total, 1)

    def run(self, epochs: Optional[int] = None,
            eval_every: int = 1) -> TrainReport:
        """Full training run with per-epoch logging (reference run())."""
        epochs = epochs if epochs is not None else self.cfg.epochs
        report = TrainReport([], [], [], [], [], [], self.timers,
                             time_skip=self.cfg.time_skip)
        for ep in range(epochs):
            t0 = time.perf_counter()
            loss, tr_acc, edges = self.train_epoch()
            check_finite_loss(loss, ep, type(self).__name__)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t0
            report.epoch_times.append(dt)
            report.losses.append(loss)
            report.train_acc.append(tr_acc)
            report.edges_per_epoch.append(edges)
            if (ep + 1) % eval_every == 0 or ep == epochs - 1:
                va = self.evaluate(self.val_nids) if self.val_nids.size else 0.0
                te = (self.evaluate(self.test_nids) if self.test_nids.size
                      else 0.0)
            else:
                va = report.val_acc[-1] if report.val_acc else 0.0
                te = report.test_acc[-1] if report.test_acc else 0.0
            report.val_acc.append(va)
            report.test_acc.append(te)
            log.info("epoch %d: loss %.5f train %.4f val %.4f test %.4f "
                     "time %.3fs edges %d", ep, loss, tr_acc, va, te, dt,
                     edges)
        if self.feat_cache is not None:
            rate, shipped, full = self.feature_cache_stats
            log.info("feature cache: hit rate %.3f, shipped %.1f MiB of "
                     "cold rows (full shipping %.1f MiB)", rate,
                     shipped / (1 << 20), full / (1 << 20))
        return report
