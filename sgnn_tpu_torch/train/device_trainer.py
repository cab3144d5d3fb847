"""Fully on-device training: sampling, gather and train step on the card.

The port of sgnn_tpu/train/device_trainer.py.  Reference: the *ALLGPU
engines (GCN_SAMPLE_ALLGPU.hpp:268-400) — device-resident topology, device
sampling, no host round trip inside the pipeline.

The padded whole-graph CSC, features and labels live on the device; each
step receives only the seed ids and runs sample → reindex → weights →
L-layer forward/backward (K1) → Adam as eager torch ops.  The JAX package
fuses an epoch into one `lax.scan` program; here an epoch is a Python loop
of steps with no host sync inside it, so `fused_epoch` keeps its meaning as
"one sync per epoch" (False syncs after every step, for debugging).  On
CUDA each step's end is marked by an event, so `step_ms` gives the
device-timeline time of every step of the last epoch without a sync inside
it; `step_losses` and `last_overflow` are read at the epoch's one sync.
CUDA graphs are later work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import RunConfig
from ..data.dataset import Dataset
from ..graph.adjacency import Adjacency
from ..sampler.blocks import SampledBatch, WeightKind, pad_to
from ..sampler.device import device_sample_batch
from ..utils.logging import get_logger
from ..utils.profiling import memory_budget
from .trainer import SampleTrainer

log = get_logger("sgnn.dev")


def feature_capacity(feature_dim: int, itemsize: int, device: torch.device,
                     budget_bytes: Optional[int] = None) -> int:
    """How many feature rows fit the device-memory budget
    (`utils.profiling.memory_budget`: half the card's free memory, a
    forced `budget_bytes` (HBM_BUDGET), or 1 GiB on the CPU, as the JAX
    package does for a backend without memory statistics)."""
    budget = memory_budget(device, budget_bytes)
    return max(budget // max(feature_dim * itemsize, 1), 0)


class FeaturesExceedHbm(ValueError):
    """The feature matrix cannot be resident on the device.

    Device sampling discovers source ids on the device, so there is no
    per-row host fallback mid-step: such graphs train through the
    host-sampled engines.  The engine registry catches this and falls
    back."""


class DeviceSampleTrainer(SampleTrainer):
    """SampleTrainer variant with on-device sampling (ALLGPU-engine analog)."""

    def __init__(
        self,
        cfg: RunConfig,
        dataset: Dataset,
        family: str = "gcn",
        weight_kind: WeightKind = WeightKind.GCN,
        degree_mode: Optional[str] = None,  # None → cfg.up_degree decides
        bias_correction: bool = False,
        adj: Optional[Adjacency] = None,
        hbm_budget_bytes: Optional[int] = None,
        device=None,
    ) -> None:
        if degree_mode is None:
            degree_mode = "sampled" if cfg.up_degree else "global"
        self.dev_degree_mode = degree_mode
        if hbm_budget_bytes is None and cfg.hbm_budget > 0:
            hbm_budget_bytes = cfg.hbm_budget
        dev = resolve_device(device)
        if dataset.features is not None:
            # residency probe (reference determine_cache_node_idx,
            # GCN_SAMPLE_PD_CACHE.hpp:1039): device sampling needs resident
            # features.  If they miss at the requested dtype but fit at
            # int8, quantize (FEATURE_DTYPE:int8); if even int8 misses,
            # raise FeaturesExceedHbm and the engine registry falls back to
            # the host-sampled path
            v, f_dim = dataset.features.shape
            fd = (cfg.feature_dtype or cfg.dtype).lower()
            itemsize = {"int8": 1, "bfloat16": 2}.get(fd, 4)
            # what else must stay resident beside the features
            budget = max(memory_budget(dev, hbm_budget_bytes)
                         - self._resident_extra_bytes(cfg, dataset), 0)
            cap = feature_capacity(f_dim, itemsize, dev, budget)
            if cap < v:
                cap8 = feature_capacity(f_dim, 1, dev, budget)
                if fd != "int8" and cap8 >= v:
                    log.warning(
                        "features exceed device memory at %s (%d of %d rows "
                        "fit): auto-switching FEATURE_DTYPE to int8 "
                        "(capacity probe; set FEATURE_DTYPE explicitly to "
                        "silence)", fd, cap, v)
                    cfg = dataclasses.replace(cfg, feature_dtype="int8")
                else:
                    raise FeaturesExceedHbm(
                        f"feature matrix needs {v} rows but only {cap8} fit "
                        "in device memory even at int8 (beside "
                        f"{self._resident_extra_bytes(cfg, dataset)} bytes "
                        "of other resident state) — use a host-sampled "
                        "engine (e.g. GCNSAMPLEGPU)")
        super().__init__(
            cfg, dataset, family=family, weight_kind=weight_kind,
            degree_mode=degree_mode, bias_correction=bias_correction, adj=adj,
            features_on_device=True, hbm_budget_bytes=hbm_budget_bytes,
            device=dev)
        d = self.device
        v = self.adj.num_vertices
        v_pad = pad_to(v, 128)
        # CSC on the device, padded to v_pad vertices (empty rows) and to a
        # multiple of 128 edges; indptr is int64 for torch's index ops
        indptr = np.concatenate([self.adj.indptr, np.full(
            v_pad - v, self.adj.indptr[-1], np.int64)])
        self.dev_indptr = torch.from_numpy(indptr).to(d)
        idx = np.zeros(pad_to(max(self.adj.num_edges, 1), 128), np.int32)
        idx[: self.adj.num_edges] = self.adj.indices
        self.dev_indices = torch.from_numpy(idx).to(d)
        # features/labels padded to v_pad rows so the bottom hop can take
        # the identity branch (x0 = the feature matrix, no re-gather)
        if v_pad > v:
            self.dev_features = torch.cat([self.dev_features, torch.zeros(
                (v_pad - v, self.dev_features.shape[1]),
                dtype=self.dev_features.dtype, device=d)])
            self.dev_labels = torch.cat([self.dev_labels, torch.zeros(
                v_pad - v, dtype=self.dev_labels.dtype, device=d)])
        self.dev_in_deg = torch.from_numpy(
            self.adj.in_degree.astype(np.int32)).to(d)
        self.dev_out_deg = torch.from_numpy(
            self.adj.out_degree.astype(np.int32)).to(d)
        # GAT's blocks carry 1 on valid slots (sgnn_tpu/train/
        # device_trainer.py:138), as the host sampler's in SampleTrainer
        self.weight_kind = WeightKind.NONE if family == "gat" else weight_kind
        self.seed_pad = pad_to(cfg.batch_size, 128)
        self.src_pads = self.compute_src_pads(cfg.batch_size)
        self.fused_epoch = True
        self.sample_generator = torch.Generator(device=d).manual_seed(
            cfg.seed + 17)
        # per step of the last epoch: device time (CUDA) and loss
        self.step_ms: List[float] = []
        self.step_losses: List[float] = []
        self.last_overflow = 0
        # x0 from row-sharded features (parallel/dp_device.py), else None
        self.fetch_x0: Optional[Callable[[SampledBatch], SampledBatch]] = None

    def compute_src_pads(self, batch_size: int) -> Tuple[int, ...]:
        """Static per-hop source bounds for a seed-batch size: the host
        sampler's plan rule (src = neighbors ∪ seeds, bounded by dst·(f+1)
        and V); with SRC_PAD_FACTOR > 0, factor × the degree-aware expected
        number of unique sources (sgnn_tpu/train/device_trainer.py:153-218),
        the sampler dropping and counting edges on the rare overflow."""
        cfg = self.cfg
        v_pad = pad_to(self.adj.num_vertices, 128)
        exact = []
        ndst = pad_to(max(batch_size, 1), 128)
        for f in cfg.fanout:
            nsrc = min(pad_to(ndst * (f + 1), 128), v_pad)
            exact.append(nsrc)
            ndst = nsrc
        if cfg.src_pad_factor <= 0:
            return tuple(exact)
        # a source v is reached iff some sampled edge (v→d) lands in the
        # hop; with ndst random destinations, edge (v→d) is sampled with
        # probability (ndst/V)·min(f/indeg(d), 1).  Poissonized per source:
        #     E[unique] = Σ_v (1 - e^{-(ndst/V)·c_v}),
        #     c_v = Σ_{d: v→d} min(f/indeg(d), 1)
        v_f = float(self.adj.num_vertices)
        dst_of_edge = np.repeat(
            np.arange(self.adj.num_vertices, dtype=np.int64),
            np.diff(self.adj.indptr).astype(np.int64))
        indeg_e = np.maximum(
            self.adj.in_degree[dst_of_edge].astype(np.float64), 1.0)
        est_pads = []
        ndst = float(batch_size)
        for h, f in enumerate(cfg.fanout):
            c_v = np.bincount(self.adj.indices.astype(np.int64),
                              weights=np.minimum(f / indeg_e, 1.0),
                              minlength=self.adj.num_vertices)
            uniq_sampled = float(-np.expm1(-(ndst / v_f) * c_v).sum())
            est = pad_to(int((uniq_sampled + ndst) * cfg.src_pad_factor), 128)
            est = min(est, exact[h])
            est_pads.append(est)
            ndst = float(est)
        log.info("src pads (b=%d): exact %s -> degree-aware estimate %s",
                 batch_size, exact, tuple(est_pads))
        return tuple(est_pads)

    # ----------------------------------------------------------- checkpoint
    def checkpoint_state(self) -> dict:
        """The host-sampled trainer's state plus the device sampler's
        generator."""
        state = super().checkpoint_state()
        state["sample_rng"] = self.sample_generator.get_state()
        return state

    def load_checkpoint_state(self, state: dict) -> None:
        super().load_checkpoint_state(state)
        self.sample_generator.set_state(state["sample_rng"])

    # ---------------------------------------------------------------- steps
    def sample(self, seeds: torch.Tensor, valid: torch.Tensor,
               omit_map: Optional[torch.Tensor] = None):
        """One device-sampled batch for padded seeds (cache-omitting at the
        bottom hop with `omit_map`).  With `fetch_x0` set (row-sharded
        features, parallel/dp_device.py) the sampler gathers no rows and
        x0 comes from it."""
        batch = device_sample_batch(
            self.sample_generator, seeds, valid, self.dev_indptr,
            self.dev_indices, self.dev_in_deg, self.dev_out_deg,
            self.dev_features, self.dev_labels, tuple(self.cfg.fanout),
            self.src_pads, self.weight_kind, degree_mode=self.dev_degree_mode,
            feat_scale=self._feat_scale, compute_dtype=self.compute_dtype,
            omit_map=omit_map, gather_features=self.fetch_x0 is None)
        return batch if self.fetch_x0 is None else self.fetch_x0(batch)

    def _seed_batches(self, nids: np.ndarray, shuffle: bool):
        nids = np.asarray(nids, dtype=np.int32)
        if shuffle:
            nids = self.sampler.rng.permutation(nids)
        for i in range(0, nids.shape[0], self.cfg.batch_size):
            chunk = nids[i:i + self.cfg.batch_size]
            seeds = np.zeros(self.seed_pad, np.int32)
            seeds[: chunk.size] = chunk
            valid = np.zeros(self.seed_pad, bool)
            valid[: chunk.size] = True
            yield (torch.from_numpy(seeds).to(self.device),
                   torch.from_numpy(valid).to(self.device))

    def _train_order(self) -> np.ndarray:
        """The epoch's seed order (BATCH_TYPE)."""
        return self._epoch_order(self.train_nids)

    def _device_step(self, step: int, seeds: torch.Tensor,
                     valid: torch.Tensor):
        """Sample and train one batch → (batch, loss, acc)."""
        batch = self.sample(seeds, valid)
        loss, acc = self.train_step(batch)
        return batch, loss, acc

    def train_epoch(self) -> Tuple[float, float, int]:
        """One epoch → (mean loss, train acc, sampled edges), with one host
        sync at its end (or one per step when `fused_epoch` is False)."""
        loss, correct, total, edges = self._train_steps(
            self._seed_batches(self._train_order(), False))
        return loss, correct / max(total, 1), edges

    def _train_steps(self, batches) -> Tuple[float, int, int, int]:
        """`_device_step` over the padded (seeds, valid) pairs of
        `batches` → (mean loss, correct, valid seeds, sampled edges); the
        data-parallel wrapper feeds it each rank's own seeds
        (parallel/dp_device.py) and sums the counts over the ranks."""
        cuda = self.device.type == "cuda"
        losses, accs, edges, overflow = [], [], [], []
        events = []
        if cuda:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        for i, (seeds, valid) in enumerate(batches):
            with self.timers.phase("device_step"):
                batch, loss, acc = self._device_step(i, seeds, valid)
                if not self.fused_epoch and cuda:
                    torch.cuda.synchronize(self.device)
            if cuda:
                events.append(torch.cuda.Event(enable_timing=True))
                events[-1].record()
            losses.append(loss)
            accs.append(acc)
            edges.append(batch.num_sampled_edges())
            overflow.append(batch.overflow)
        if not losses:
            return 0.0, 0, 0, 0
        stacked = torch.stack(losses)
        mean_loss = float(stacked.mean())   # the epoch's sync
        self.step_losses = stacked.tolist()
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        self.last_overflow = int(torch.stack(overflow).sum())
        self.step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        return mean_loss, int(correct), int(total), int(torch.stack(
            edges).sum())

    @torch.no_grad()
    def evaluate(self, nids: np.ndarray) -> float:
        accs = []
        for seeds, valid in self._seed_batches(nids, False):
            with self.timers.phase("device_eval"):
                accs.append(self.eval_step(self.sample(seeds, valid)))
        if not accs:
            return 0.0
        correct, total = torch.stack(accs).sum(dim=0).tolist()
        return correct / max(total, 1)

