"""Whole-graph (full-neighborhood) forward and training for GCN, GraphSAGE
and GAT.

The port of `sgnn_tpu/train/fullbatch.py`: `build_coo`, `full_forward`
and the single-device `FullBatchTrainer` (the *FULLBATCH engines).  Per
layer of `full_forward`:

    GCN/SAGE, sum, transform first when in > out:  h = spmm(h @ W)
              else:                                  h = spmm(h) @ W
              hidden layers: dropout(relu(bn(h))); last: log_softmax in f32
    GCN/SAGE, AGGREGATOR min/max (every layer transform first):
              h = min/max over in-edges of (h @ W)[src], the same activations
    GAT:      ht = h @ W; (ts, td) = score tables of ht with a = attn[l]
              (heads on hidden layers, one head on the last);
              h = gat_aggregate(ht, ts, td[dst rows], csr)
              dropout(relu(bn(h))) on hidden layers, relu(h) then
              log_softmax in f32 on the last (the reference GAT's relu at
              every layer)

The aggregations are the CSR SpMM of ops/segment.py and the attention
aggregation of ops/gat.py (hand-written kernels on the card); min/max are
torch ops (ops/reductions.py), as XLA computes them in the JAX package; the
dense products are `torch.matmul`, as the JAX package left them to XLA.
Under autograd the SpMM and the attention differentiate through their
kernels' backward (K2's backward, K4), over the transposed CSR that the
caller builds once (`graph_t`).  Float32 products are meant to run in full
float32: TF32 keeps only about three decimal digits and the port is held
to the reference at 1e-5.  `InferenceServer` and `FullBatchTrainer` switch
TF32 off when they are built on CUDA; a caller of `full_forward` alone on
the card owns that flag.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import resolve_device
from ..config import RunConfig
from ..data.dataset import Dataset, MASK_TEST, MASK_TRAIN, MASK_VAL
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads, init_model
from ..nn.functional import BN_EPS, dropout, log_softmax, nll_loss_masked
from ..nn.optim import make_optimizer
from ..ops.gat import GatAggregate, gat_aggregate, pack_score_tables
from ..ops.reductions import segment_extreme
from ..ops.segment import Csr, SpmmCsr, csr_from_numpy, csr_transpose, spmm_csr
from ..sampler.blocks import WeightKind
from ..utils.logging import get_logger
from .guard import check_finite_loss

log = get_logger("sgnn.full")

AGGREGATORS = ("sum", "min", "max")


def check_ported(family: str, aggregator: str = "sum") -> None:
    """Raise ValueError for a family or an aggregator neither package
    takes.  GAT ignores `aggregator`, as the JAX package does
    (fullbatch.py:203)."""
    if family not in ("gcn", "sage", "gat"):
        raise ValueError(f"unknown model family {family!r}")
    if family != "gat" and aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}")


def build_coo(adj: Adjacency, weight_kind: WeightKind
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-graph (src, dst, weight) arrays in CSC order, unpadded: the
    first E entries of the JAX package's `build_coo`, same arithmetic
    (MEAN here is the full-batch sym-norm/indeg hybrid)."""
    v = adj.num_vertices
    dst = np.repeat(np.arange(v, dtype=np.int32),
                    np.diff(adj.indptr).astype(np.int64))
    src = adj.indices.astype(np.int32)
    if weight_kind == WeightKind.GCN:
        w = adj.gcn_edge_weight(src, dst)
    elif weight_kind == WeightKind.MEAN:
        w = adj.gcn_edge_weight(src, dst) / np.maximum(adj.in_degree[dst], 1)
    else:
        w = np.ones(src.size, np.float32)
    return src, dst, w.astype(np.float32)


def _bn(t: torch.Tensor) -> torch.Tensor:
    """Whole-graph batch norm: per-feature population statistics in f32."""
    t32 = t.float()
    mu = t32.mean(dim=0, keepdim=True)
    var = t32.var(dim=0, unbiased=False, keepdim=True)
    return ((t32 - mu) * torch.rsqrt(var + BN_EPS)).to(t.dtype)


def _gat_layer(ht: torch.Tensor, attn: torch.Tensor, csr: Csr,
               csr_t: Optional[Csr], dst_rows: Optional[torch.Tensor],
               heads: int) -> torch.Tensor:
    """One attention aggregation (pre-activation): the score tables of the
    layer's rows, the destinations' half gathered at `dst_rows` (None when
    the rows are the destinations, as in the whole graph), then K3 — through
    `GatAggregate` (K4 in the backward) when `csr_t` is given."""
    f = ht.shape[1]
    a_src = attn[:f, 0].to(ht.dtype)
    a_dst = attn[f:, 0].to(ht.dtype)
    ts, td = pack_score_tables(ht, a_src, a_dst, heads)
    if dst_rows is not None:
        td = td.index_select(0, dst_rows)
    if csr_t is not None:
        return GatAggregate.apply(ht, ts, td, csr.rowptr, csr.col,
                                  csr_t.rowptr, csr_t.col, heads)
    h, _ = gat_aggregate(ht, ts, td, csr.rowptr, csr.col, heads)
    return h


def full_forward(
    params: GNNParams,
    family: str,
    x: torch.Tensor,
    graph: Union[Csr, Sequence[Csr]],
    *,
    batch_norm: bool = False,
    aggregator: str = "sum",
    heads: int = 1,
    dst_rows: Optional[Sequence[torch.Tensor]] = None,
    graph_t: Optional[Csr] = None,
    drop_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """L-layer forward: [rows of the last graph, C] float32 log-probs.

    `graph` is one Csr shared by every layer (the whole graph: rows and
    sources are all V vertices) or one Csr per layer, bottom first, whose
    layer-l rows are the sources of layer l+1 (a query neighborhood); then
    `dst_rows[l]` (int64) gives the row of each of layer l's destinations
    among its sources, which GAT needs for the destinations' score half.
    For GCN/SAGE the edge weights in the Csr decide the family, and
    `aggregator` "min"/"max" replaces the weighted sum (the weights then
    only count as edges); GAT reads no weights, ignores `aggregator`, and
    takes `heads` on its hidden layers (GCN/SAGE ignore it, as in the JAX
    package).  `batch_norm` standardizes each hidden pre-activation per
    feature over all rows before relu.

    Training: `graph_t` is the whole graph's transposed CSR
    (`ops/segment.csr_transpose`), which the SpMM's and the attention's
    backward run over.  A forward that autograd records (grad mode on and
    an input or parameter requiring grad) through a sum or attention
    aggregation raises without it.  `drop_rate` > 0 with a `generator`
    applies dropout to each hidden layer's activations (drawn from the
    generator, on x's device)."""
    check_ported(family, aggregator)
    check_heads(params, family, heads)
    n_layers = len(params.weights)
    graphs = [graph] * n_layers if isinstance(graph, Csr) else list(graph)
    if len(graphs) != n_layers:
        raise ValueError(f"{n_layers} layers but {len(graphs)} graphs")
    if dst_rows is None:
        if not isinstance(graph, Csr) and family == "gat":
            raise ValueError("GAT over per-layer graphs needs dst_rows")
        dst_rows = [None] * n_layers
    minmax = family != "gat" and aggregator in ("min", "max")
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params.leaves()))
    if recorded and not minmax:
        if graph_t is None:
            raise ValueError("full_forward under autograd needs graph_t, the "
                             "transposed CSR its backward runs over")
        if not isinstance(graph, Csr):
            raise ValueError("full_forward trains over the whole graph only")
    csr_t = graph_t if recorded else None
    train_drop = drop_rate > 0.0 and generator is not None

    def hidden(t: torch.Tensor) -> torch.Tensor:
        t = torch.relu(_bn(t) if batch_norm else t)
        return dropout(generator, t, drop_rate, True) if train_drop else t

    def spmm(t: torch.Tensor, csr: Csr) -> torch.Tensor:
        if csr_t is None:
            return spmm_csr(t, *csr)
        return SpmmCsr.apply(t, *csr, *csr_t)

    h = x
    for l, (wl, csr, rows) in enumerate(zip(params.weights, graphs,
                                            dst_rows)):
        last = l == n_layers - 1
        wl = wl.to(h.dtype)
        if minmax:
            h = segment_extreme(torch.matmul(h, wl), csr.rowptr, csr.col,
                                aggregator)
        elif family == "gat":
            h = _gat_layer(torch.matmul(h, wl), params.attn[l], csr, csr_t,
                           rows, 1 if last else heads)
            if last:
                h = torch.relu(h)
        elif wl.shape[0] > wl.shape[1]:  # transform-first: fewer columns
            h = spmm(torch.matmul(h, wl), csr)
        else:
            h = torch.matmul(spmm(h, csr), wl)
        h = log_softmax(h.float()) if last else hidden(h)
    return h


class FullBatchTrainer:
    """Whole-graph training on one device (the *FULLBATCH engines).

    The port of the JAX `FullBatchTrainer` with `mesh=None`: the whole
    graph's CSR and its transpose, the features, labels and split masks
    stay resident on the device; an epoch is one forward over every vertex,
    the masked NLL over the train vertices, one backward (K2's backward or
    K4 on the card) and one update of the bias-corrected reference Adam
    (or SGD, by OPTIMIZER).  `train_epoch()` returns (loss, train, val,
    test), the accuracies of the parameters before the update: from the
    training forward's log-probs under METRICS:train or at drop 0, else
    (METRICS:clean) from one more forward without dropout.  DTYPE:bfloat16
    keeps features and activations in bf16 (the kernels sum in f32);
    MXU_SPMM is read and ignored (it picks a TPU plan).  Dropout draws come
    from a `torch.Generator` seeded with SEED + 7919, other bits than the
    JAX package's key.

    Not ported yet, raising NotImplementedError with the ROADMAP item: a
    mesh, PARTITION_GRAPH and HALO:targeted (item 6), FEATURE_DTYPE:int8
    and checkpoints (item 4).  `device=None` means CUDA and raises without
    a card; `device="cpu"` runs the kernels' plain versions."""

    def __init__(
        self,
        cfg: RunConfig,
        dataset: Dataset,
        family: str = "gcn",
        weight_kind: WeightKind = WeightKind.GCN,
        mesh=None,
        adj: Optional[Adjacency] = None,
        halo: str = "all_gather",
        aggregator: Optional[str] = None,
        device=None,
    ) -> None:
        if mesh is not None or cfg.partition_graph:
            raise NotImplementedError(
                "vertex-sharded whole-graph training (mesh, PARTITION_GRAPH) "
                "is not ported yet: ROADMAP Queue 1 item 6")
        halo = (halo or "all_gather").lower()
        if halo not in ("all_gather", "targeted"):
            raise ValueError(
                f"HALO must be 'all_gather' or 'targeted', got {halo!r}")
        if halo == "targeted":
            raise NotImplementedError(
                "HALO:targeted (sharded whole-graph training) is not ported "
                "yet: ROADMAP Queue 1 item 6")
        fd = (cfg.feature_dtype or cfg.dtype).lower()
        if fd == "int8":
            raise NotImplementedError(
                "FEATURE_DTYPE:int8 waits for the serving-extras slice "
                "(ROADMAP Queue 1 item 4)")
        self.cfg = cfg
        self.dataset = dataset
        self.family = family
        self.aggregator = (aggregator if aggregator is not None
                           else cfg.aggregator).lower()
        check_ported(family, self.aggregator)
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # full f32 products, as the JAX package computes them
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        self.adj = adj if adj is not None else Adjacency.from_edges(
            dataset.edges, dataset.num_vertices)
        self.weight_kind = weight_kind
        wk = WeightKind.NONE if family == "gat" else weight_kind
        src, _, w = build_coo(self.adj, wk)
        v = self.adj.num_vertices
        self.csr = csr_from_numpy(self.adj.indptr, src, w, v, self.device)
        # the transposed CSR the backward runs over (min/max need none)
        self.transpose_s = 0.0
        self.csr_t = None
        if family == "gat" or self.aggregator == "sum":
            t1 = time.perf_counter()
            rowptr_t, col_t, w_t = csr_transpose(self.adj.indptr, src, w, v)
            self.transpose_s = time.perf_counter() - t1
            self.csr_t = csr_from_numpy(rowptr_t, col_t, w_t, v, self.device)
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        self.x = torch.from_numpy(np.ascontiguousarray(
            dataset.features, np.float32)).to(self.device, self.compute_dtype)
        self.y = torch.from_numpy(dataset.labels.astype(np.int64)).to(
            self.device)
        self.masks = [torch.from_numpy(dataset.masks == m).to(self.device)
                      for m in (MASK_TRAIN, MASK_VAL, MASK_TEST)]
        self.params = init_model(cfg.seed, family, cfg.layer_sizes,
                                 device=self.device)
        check_heads(self.params, family, cfg.heads)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 7919)
        # OPTIMIZER cfg key, bias-corrected like the CPU engines'
        # learnC2C_with_decay_Adam (NtsScheduler.hpp:863)
        self.optimizer = make_optimizer(cfg, bias_correction=True)
        self.opt_state = self.optimizer.init(self.params.leaves())
        self.clean_metrics = cfg.metrics != "train"
        self.build_s = time.perf_counter() - t0

    # -------------------------------------------------------------- forward
    def forward(self, params: GNNParams, train: bool) -> torch.Tensor:
        """Whole-graph log-probs [V, C]: with dropout and the transposed CSR
        for autograd when `train`, without both otherwise."""
        return full_forward(
            params, self.family, self.x, self.csr,
            batch_norm=self.cfg.batch_norm, aggregator=self.aggregator,
            heads=self.cfg.heads, graph_t=self.csr_t if train else None,
            drop_rate=self.cfg.drop_rate if train else 0.0,
            generator=self.generator if train else None)

    # ------------------------------------------------------------------ run
    def train_epoch(self) -> Tuple[float, float, float, float]:
        """One forward/backward/update over the whole graph → (loss, train,
        val, test accuracy); one host sync."""
        leaves = [p.detach().requires_grad_() for p in self.params.leaves()]
        logp = self.forward(self.params.replace_leaves(leaves), train=True)
        loss = nll_loss_masked(logp, self.y, self.masks[0])
        loss.backward()
        logp = logp.detach()
        if self.cfg.drop_rate > 0.0 and self.clean_metrics:
            with torch.no_grad():
                logp = self.forward(self.params, train=False)
        new, self.opt_state = self.optimizer.update(
            [p.grad for p in leaves], self.opt_state, self.params.leaves())
        self.params = self.params.replace_leaves(new)
        correct = logp.argmax(dim=-1) == self.y
        accs = [(correct & m).sum() / m.sum().clamp_min(1) for m in self.masks]
        out = torch.stack([loss.detach().float(), *accs]).tolist()
        return out[0], out[1], out[2], out[3]

    @property
    def train_nids(self) -> np.ndarray:
        return self.dataset.nids_with_mask(MASK_TRAIN)

    @property
    def val_nids(self) -> np.ndarray:
        return self.dataset.nids_with_mask(MASK_VAL)

    @property
    def test_nids(self) -> np.ndarray:
        return self.dataset.nids_with_mask(MASK_TEST)

    @torch.no_grad()
    def predict(self) -> np.ndarray:
        """Whole-graph [V, classes] f32 log-probs through the trainer's own
        forward (same edge weights, AGGREGATOR, BATCH_NORM), no dropout."""
        return self.forward(self.params, train=False).cpu().numpy()

    def evaluate(self, nids: np.ndarray) -> float:
        """Exact whole-graph accuracy over the given vertex ids."""
        nids = np.asarray(nids)
        if nids.size == 0:
            return 0.0
        pred = np.argmax(self.predict(), axis=-1)
        labels = np.asarray(self.dataset.labels)
        return float((pred[nids] == labels[nids]).mean())

    def checkpoint_state(self):
        raise NotImplementedError("checkpoints wait for the serving-extras "
                                  "slice (ROADMAP Queue 1 item 4)")

    def load_checkpoint_state(self, state) -> None:
        raise NotImplementedError("checkpoints wait for the serving-extras "
                                  "slice (ROADMAP Queue 1 item 4)")

    def run(self, epochs: Optional[int] = None) -> List[dict]:
        epochs = epochs or self.cfg.epochs
        hist = []
        for ep in range(epochs):
            t0 = time.perf_counter()
            loss, tr, va, te = self.train_epoch()
            check_finite_loss(loss, ep, type(self).__name__)
            dt = time.perf_counter() - t0
            hist.append(dict(loss=loss, train=tr, val=va, test=te, time=dt))
            log.info("full epoch %d: loss %.5f train %.4f val %.4f test %.4f "
                     "(%.3fs)", ep, loss, tr, va, te, dt)
        return hist
