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
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import RunConfig
from ..data.dataset import Dataset, MASK_TEST, MASK_TRAIN, MASK_VAL
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads, init_model, model_forward
from ..nn.functional import masked_accuracy, nll_loss_masked
from ..nn.optim import make_optimizer
from ..sampler.blocks import SampledBatch, SampledBlock, WeightKind
from ..sampler.host import HostSampledBatch, HostSampler
from ..utils.logging import get_logger
from ..utils.timing import PhaseTimer
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

    @property
    def avg_epoch_time(self) -> float:
        n = len(self.epoch_times)
        if n == 0:
            return 0.0
        skip = min(n - 1, max(self.time_skip, 0))
        times = self.epoch_times[skip:]
        return float(np.mean(times)) if times else 0.0


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
                   heads: int = 1) -> StepOut:
    """Forward, masked NLL and its gradient with respect to every weight
    and attention vector: the differentiated part of a training step, on
    the batch's device."""
    leaves = [p.detach().requires_grad_() for p in params.leaves()]
    logp = model_forward(params.replace_leaves(leaves), family, batch,
                         drop_rate=drop_rate, train=True, generator=generator,
                         remat=remat, batch_norm=batch_norm, heads=heads)
    loss = nll_loss_masked(logp, batch.labels, batch.label_valid)
    loss.backward()
    return StepOut(loss.detach(), logp.detach(), [p.grad for p in leaves])


class _HostItem(NamedTuple):
    """What the prefetch thread hands over: host arrays only."""

    hb: HostSampledBatch
    x0: np.ndarray
    y: np.ndarray
    y_valid: np.ndarray


class SampleTrainer:
    """Single-device sampled training engine over the host sampler."""

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
        if self.device.type == "cuda":
            # full f32 products, as the JAX package computes them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
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
        self.sampler = HostSampler(
            self.adj, fanouts=cfg.fanout, batch_size=cfg.batch_size,
            weight_kind=weight_kind, degree_mode=degree_mode, seed=cfg.seed)
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        fd = (cfg.feature_dtype or cfg.dtype).lower()
        if fd == "int8":
            raise NotImplementedError(
                "int8 features wait for the serving-extras slice (ROADMAP "
                "Queue 1 item 4)")
        if fd not in ("float32", "bfloat16"):
            raise ValueError(f"FEATURE_DTYPE must be float32|bfloat16|int8, "
                             f"got {fd!r}")
        if hbm_budget_bytes is None and cfg.hbm_budget > 0:
            hbm_budget_bytes = cfg.hbm_budget
        store_dtype = torch.bfloat16 if fd == "bfloat16" else torch.float32
        if features_on_device is None:
            limit = (hbm_budget_bytes if hbm_budget_bytes is not None
                     else RESIDENT_FEATURE_BYTES)
            features_on_device = (
                dataset.features is not None
                and dataset.features.shape[0] * dataset.features.shape[1]
                * store_dtype.itemsize < limit)
        self.features_on_device = features_on_device
        if not features_on_device and cfg.feature_cache_rate > 0:
            raise NotImplementedError(
                "the partial feature cache (FEATURE_CACHE_RATE > 0) waits for "
                "the cache slice (ROADMAP Queue 1 item 5)")
        if features_on_device:
            self.dev_features = torch.from_numpy(
                np.ascontiguousarray(dataset.features)).to(self.device,
                                                           store_dtype)
            self.dev_labels = torch.from_numpy(
                dataset.labels.astype(np.int64)).to(self.device)
        else:
            self.dev_features = None
            self.dev_labels = None
        self.params = init_model(cfg.seed, family, cfg.layer_sizes,
                                 device=self.device)
        check_heads(self.params, family, cfg.heads)
        # OPTIMIZER cfg key picks Adam (default) or the reference's SGD rule
        self.optimizer = make_optimizer(cfg, bias_correction)
        self.opt_state = self.optimizer.init(self.params.leaves())
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self.timers = PhaseTimer()

    # ----------------------------------------------------------- checkpoint
    def checkpoint_state(self):
        raise NotImplementedError("checkpoints wait for the serving-extras "
                                  "slice (ROADMAP Queue 1 item 4)")

    def load_checkpoint_state(self, state) -> None:
        raise NotImplementedError("checkpoints wait for the serving-extras "
                                  "slice (ROADMAP Queue 1 item 4)")

    # --------------------------------------------------------------- steps
    def train_step(self, batch: SampledBatch) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """One forward/backward/update on `batch`; returns the loss and the
        (correct, valid) counts as device tensors."""
        out = loss_and_grads(self.params, self.family, batch,
                             drop_rate=self.cfg.drop_rate,
                             generator=self.generator, remat=self.cfg.remat,
                             batch_norm=self.cfg.batch_norm,
                             heads=self.cfg.heads)
        new, self.opt_state = self.optimizer.update(
            out.grads, self.opt_state, self.params.leaves())
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
    def _make_batch(self, seeds: np.ndarray) -> _HostItem:
        """Producer side: sample and gather the host payload (no CUDA)."""
        with self.timers.phase("sample"):
            hb = self.sampler.sample(seeds)
            if self.features_on_device:
                # x0/labels are gathered on the device; ship ids only
                top = hb.blocks[-1]
                return _HostItem(hb, np.zeros((1, 1), np.float32),
                                 np.zeros(top.seeds.shape[0], np.int32),
                                 top.dst_valid)
            return _HostItem(hb, *hb.payload(self.dataset.features,
                                             self.dataset.labels))

    def _upload(self, item: _HostItem) -> Tuple[SampledBatch, int]:
        """Consumer side: upload, and gather x0/labels on the device when
        the features are resident there."""
        with self.timers.phase("transfer"):
            batch = host_batch_to_device(item.hb, item.x0, item.y,
                                         item.y_valid, self.device)
            if self.features_on_device:
                b0, top = batch.blocks[0], batch.blocks[-1]
                rows = self.dev_features.index_select(0, b0.srcs.long())
                x0 = torch.where(b0.src_valid[:, None], rows,
                                 torch.zeros((), dtype=rows.dtype,
                                             device=rows.device))
                batch = dataclasses.replace(
                    batch, x0=x0.to(self.compute_dtype),
                    labels=self.dev_labels[top.seeds.long()])
            else:
                batch = dataclasses.replace(
                    batch, x0=batch.x0.to(self.compute_dtype))
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
        for batch, nedges in self._batch_stream(
                self._epoch_order(self.train_nids), shuffle=False):
            with self.timers.phase("train_step"):
                loss, acc = self.train_step(batch)
            losses.append(loss)
            accs.append(acc)
            edges += nedges
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
        return report
