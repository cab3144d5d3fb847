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

int8 features (FEATURE_DTYPE:int8, data/quant.py) enter as the int8 matrix
and its [F] per-column scales, `x_scale`: dequantization commutes with the
layer-0 product and with the aggregation, so the scales fold into W0 (row
f of W0 times scale[f], as sgnn_tpu/train/fullbatch.py:146-157) and the
int8 levels are used as floats.  Where layer 0 starts with its product
(transform-first, GAT, min/max) the levels are converted in blocks of
INT8_BLOCK_ROWS rows before the product and again in its backward, so the
f32 transient is one block ([65,536, F], 158 MB at F=602) and not the
[V, F] matrix, and training keeps no f32 copy for the backward; where it
starts with the aggregation (in <= out, features no wider than the layer)
the whole matrix is converted, no larger than the layer's output.
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import full_f32_products, resolve_device
from ..config import RunConfig
from ..data.dataset import Dataset, MASK_TEST, MASK_TRAIN, MASK_VAL
from ..data.quant import quantize_columns
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads, init_model, refuse_gatconv
from ..nn.functional import BN_EPS, dropout, log_softmax
from ..nn.optim import make_optimizer
from ..ops.gat import GatAggregate, gat_aggregate, pack_score_tables
from ..ops.reductions import segment_extreme
from ..ops.segment import Csr, SpmmCsr, csr_from_numpy, csr_transpose, spmm_csr
from ..parallel.halo import (
    all_reduce_sum, build_targeted_halo, halo_exchange, own_rows,
    shard_graph, shard_on_device, sharded_aggregate,
    sharded_aggregate_targeted, sharded_gat_layer,
)
from ..parallel.mesh import DataGroup
from ..sampler.blocks import WeightKind
from ..utils.logging import get_logger
from ..utils.timing import PhaseTimer, span
from .checkpoint import (
    load_opt_state, load_params, opt_state_dict, params_state,
)
from .guard import check_finite_loss

log = get_logger("sgnn.full")

# rows of int8 features converted to floats at a time before the layer-0
# product (full_forward): bounds the f32 transient of int8 residency
INT8_BLOCK_ROWS = 1 << 16

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


class _RowsMatmul(torch.autograd.Function):
    """x @ w for int8 levels x: converted to w's dtype INT8_BLOCK_ROWS rows
    at a time, each block's product written into one [V, out] result.  The
    backward (w's gradient, x^T g) converts the same blocks again, so only
    the int8 x is kept between the passes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        out = w.new_empty(x.shape[0], w.shape[1])
        for a in range(0, x.shape[0], INT8_BLOCK_ROWS):
            b = a + INT8_BLOCK_ROWS
            torch.matmul(x[a:b].to(w.dtype), w, out=out[a:b])
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        gw = None
        for a in range(0, x.shape[0], INT8_BLOCK_ROWS):
            b = a + INT8_BLOCK_ROWS
            part = x[a:b].to(g.dtype).t().matmul(g[a:b])
            gw = part if gw is None else gw.add_(part)
        return None, gw


def _fold_x_scale(params: GNNParams, x: torch.Tensor,
                  x_scale: Optional[torch.Tensor]) -> GNNParams:
    """The parameters an int8 `x` enters with: W0 · x_scale[:, None]
    (module docstring); the same parameters for a float `x`."""
    if x.dtype == torch.int8:
        if x_scale is None:
            raise ValueError("int8 features need x_scale")
        w0 = params.weights[0] * x_scale.to(params.weights[0].dtype)[:, None]
        return params._replace(weights=(w0, *params.weights[1:]))
    if x_scale is not None:
        raise ValueError(f"x_scale is for int8 features, x is {x.dtype}")
    return params


def _layer_product(h: torch.Tensor, wl: torch.Tensor,
                   x_scale: Optional[torch.Tensor]):
    """(W in the layer's dtype, the product h @ W): int8 rows go through
    `_RowsMatmul` in x_scale's dtype."""
    if h.dtype == torch.int8:
        return wl.to(x_scale.dtype), _RowsMatmul.apply
    return wl.to(h.dtype), torch.matmul


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
    x_scale: Optional[torch.Tensor] = None,
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
    generator, on x's device).

    `x_scale` ([F] per-column scales, float32 or bfloat16) marks an int8
    `x` (FEATURE_DTYPE:int8): W0 becomes W0 · x_scale[:, None], and the
    int8 levels enter as x_scale's dtype (module docstring)."""
    check_ported(family, aggregator)
    refuse_gatconv(params, "full_forward")
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
    params = _fold_x_scale(params, x, x_scale)

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
        wl, matmul = _layer_product(h, wl, x_scale)
        if minmax:
            h = segment_extreme(matmul(h, wl), csr.rowptr, csr.col,
                                aggregator)
        elif family == "gat":
            h = _gat_layer(matmul(h, wl), params.attn[l], csr, csr_t,
                           rows, 1 if last else heads)
            if last:
                h = torch.relu(h)
        elif wl.shape[0] > wl.shape[1]:  # transform-first: fewer columns
            h = spmm(matmul(h, wl), csr)
        else:
            h = torch.matmul(spmm(h.to(wl.dtype), csr), wl)
        h = log_softmax(h.float()) if last else hidden(h)
    return h


class FullBatchTrainer:
    """Whole-graph training (the *FULLBATCH engines), on one device or
    vertex-sharded over the ranks of a graph group.

    The port of the JAX `FullBatchTrainer`.  With `mesh=None` the whole
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

    `mesh` is a graph group (parallel/mesh.make_group(graph=n): every rank
    on the graph axis, one process a rank; a one-rank group runs the
    sharded program with n = 1), the JAX trainer's mesh, sharded over all
    of its ranks.  Each rank then holds the real rows of its slot block of
    x, y and the masks (its owned vertex range) and its shard's CSR and
    transpose (parallel/halo.py: balance by PARTITION_BALANCE, halo by
    `halo`, all_gather or targeted), as the JAX `_init_sharded` /
    `_forward_local` (sgnn_tpu/train/fullbatch.py:567-857): every layer
    exchanges its rows and aggregates shard-locally; every rank draws the
    whole [V, F] dropout mask from the same generator, as the
    single-device trainer does, and keeps its own range (so n ranks train
    as one device does, draw for draw, and one rank bit for bit but for
    batch norm); batch norm takes f32 sums over the real rows,
    all-reduced; each rank's loss is its masked NLL sum over the global
    train count, and one `DataGroup.reduce_grads` SUM a step gives the
    exact global gradient.
    Every rank calls every method: each reaches the same collectives in
    the same order.  Without a mesh, HALO is kept on `.halo` and read
    only under one (the JAX package's single-device program).

    FEATURE_DTYPE:int8 keeps the features (or each rank's rows) quantized
    on the device (`.x` int8, `.x_scale` [F] in the compute dtype), folded
    into W0 by the forward.  `checkpoint_state` / `load_checkpoint_state`
    carry the parameters, the optimizer state and the dropout generator
    (train/checkpoint.py), replicated over the ranks of a mesh.
    `device=None` means CUDA and raises without a card; `device="cpu"`
    runs the kernels' plain versions; under a mesh the device is the
    group's."""

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
        halo = (halo or "all_gather").lower()
        if halo not in ("all_gather", "targeted"):
            raise ValueError(
                f"HALO must be 'all_gather' or 'targeted', got {halo!r}")
        # read only under a mesh, as in the JAX package
        self.halo = halo
        fd = (cfg.feature_dtype or cfg.dtype).lower()
        self.feature_int8 = fd == "int8"
        self.cfg = cfg
        self.dataset = dataset
        self.family = family
        self.aggregator = (aggregator if aggregator is not None
                           else cfg.aggregator).lower()
        check_ported(family, self.aggregator)
        self.group = _graph_group(mesh, device)
        self.device = (resolve_device(device) if mesh is None
                       else self.group.device)
        full_f32_products(self.device)
        t0 = time.perf_counter()
        self.adj = adj if adj is not None else Adjacency.from_edges(
            dataset.edges, dataset.num_vertices)
        self.weight_kind = weight_kind
        wk = WeightKind.NONE if family == "gat" else weight_kind
        src, _, w = build_coo(self.adj, wk)
        v = self.adj.num_vertices
        self.compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                              else torch.float32)
        # the transposed CSR the backward runs over (min/max need none)
        transpose = family == "gat" or self.aggregator == "sum"
        self.transpose_s = 0.0
        if self.feature_int8:
            q, scale = quantize_columns(dataset.features)
            self.x_scale = torch.from_numpy(scale).to(self.device,
                                                      self.compute_dtype)
        else:
            q = np.ascontiguousarray(dataset.features, np.float32)
            self.x_scale = None
        labels = dataset.labels.astype(np.int64)
        masks = [dataset.masks == m for m in (MASK_TRAIN, MASK_VAL, MASK_TEST)]
        if self.group is None:
            self.csr = csr_from_numpy(self.adj.indptr, src, w, v,
                                      self.device)
            self.csr_t = None
            if transpose:
                t1 = time.perf_counter()
                rowptr_t, col_t, w_t = csr_transpose(self.adj.indptr, src, w,
                                                     v)
                self.transpose_s = time.perf_counter() - t1
                self.csr_t = csr_from_numpy(rowptr_t, col_t, w_t, v,
                                            self.device)
            rows_of = np.asarray   # every vertex, in global order
        else:
            self._init_sharded(w, transpose)
            rows_of = self._local_rows
        self.x = torch.from_numpy(rows_of(q)).to(self.device)
        if not self.feature_int8:
            self.x = self.x.to(self.compute_dtype)
        self.y = torch.from_numpy(rows_of(labels)).to(self.device)
        self.masks = [torch.from_numpy(rows_of(m)).to(self.device)
                      for m in masks]
        # the global counts of the train/val/test vertices (f32: the loss's
        # and the accuracies' divisors)
        self.mask_counts = torch.tensor([max(int(m.sum()), 1) for m in masks],
                                        dtype=torch.float32,
                                        device=self.device)
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
        # its phase totals stay empty, as the JAX package's; the epochs
        # `train_epoch` has run are the spans' epoch identifier
        self.timers = PhaseTimer()
        self.epochs_run = 0
        self.build_s = time.perf_counter() - t0

    # -------------------------------------------------------------- sharded
    def _init_sharded(self, w: np.ndarray, transpose: bool) -> None:
        """This rank's shard: the plans on the host (every rank builds the
        same), its CSR and transpose on its device, and its range."""
        n, part = self.group.world_size, self.group.rank
        balance = self.cfg.partition_balance
        self.sharded = shard_graph(self.adj, n, w, balance=balance)
        plan = self.sharded
        if self.halo == "targeted":
            plan = build_targeted_halo(self.adj, n, w, balance=balance)
        t1 = time.perf_counter()
        self.shard = shard_on_device(plan, part, self.device, transpose)
        self.transpose_s = time.perf_counter() - t1
        start, size = (int(c) for c in self.sharded.shard_meta[part])
        self.range_start, self.owned = start, size

    def _local_rows(self, a: np.ndarray) -> np.ndarray:
        """This rank's real rows of a vertex-indexed array: its owned
        range, the first `owned` rows of its slot block (the sharded
        forward keeps only these between layers)."""
        return np.ascontiguousarray(
            a[self.range_start:self.range_start + self.owned])

    def _shard_dropout(self, t: torch.Tensor) -> torch.Tensor:
        """Layout-invariant dropout (sgnn_tpu/train/fullbatch.py:688-708):
        the keep mask of the whole [V, F] activation, drawn as the
        single-device trainer draws it, sliced to this rank's range."""
        rate = self.cfg.drop_rate
        draw = torch.rand((self.adj.num_vertices, t.shape[1]),
                          generator=self.generator, device=t.device)
        keep = draw[self.range_start:self.range_start + self.owned] < (
            1.0 - rate)
        return torch.where(keep, t / (1.0 - rate),
                           torch.zeros((), dtype=t.dtype, device=t.device))

    def _sync_bn(self, t: torch.Tensor) -> torch.Tensor:
        """Synchronized batch norm (sgnn_tpu/train/fullbatch.py:710-728):
        per-feature statistics over every rank's real rows, f32 sums
        all-reduced."""
        t32 = t.float()
        v = float(self.adj.num_vertices)
        mu = all_reduce_sum(t32.sum(0), self.group, "bn_all_reduce") / v
        d = t32 - mu
        var = all_reduce_sum((d * d).sum(0), self.group, "bn_all_reduce") / v
        return (d * torch.rsqrt(var + BN_EPS)).to(t.dtype)

    def _forward_sharded(self, params: GNNParams, train: bool
                         ) -> torch.Tensor:
        """This rank's [owned, C] f32 log-probs: `full_forward`'s layers
        with each aggregation an exchange and a shard-local layer
        (sgnn_tpu/train/fullbatch.py `_forward_local`).  Between layers a
        rank keeps only its real rows, so its dense products and batch-norm
        sums run over them alone: with one rank, every product has the
        single-device program's shape."""
        cfg, shard, group, owned = self.cfg, self.shard, self.group, self.owned
        drop = train and cfg.drop_rate > 0.0
        params = _fold_x_scale(params, self.x, self.x_scale)
        minmax = self.family != "gat" and self.aggregator in ("min", "max")
        agg = (sharded_aggregate_targeted if self.halo == "targeted"
               else sharded_aggregate)
        n_layers = len(params.weights)
        h = self.x
        for l, wl in enumerate(params.weights):
            last = l == n_layers - 1
            wl, matmul = _layer_product(h, wl, self.x_scale)
            if minmax:  # DistAggregateDstMin/Max: shard-local after the halo
                h = segment_extreme(halo_exchange(matmul(h, wl), shard, group),
                                    shard.csr.rowptr, shard.csr.col,
                                    self.aggregator)[:owned]
            elif self.family == "gat":
                h = sharded_gat_layer(matmul(h, wl), params.attn[l], shard,
                                      group, 1 if last else cfg.heads)[:owned]
                if last:
                    h = torch.relu(h)
            elif wl.shape[0] > wl.shape[1]:  # transform-first
                h = agg(matmul(h, wl), shard, group)[:owned]
            else:
                h = torch.matmul(agg(h.to(wl.dtype), shard, group)[:owned],
                                 wl)
            if last:
                h = log_softmax(h.float())
            else:
                h = torch.relu(self._sync_bn(h) if cfg.batch_norm else h)
                h = self._shard_dropout(h) if drop else h
        return h

    # -------------------------------------------------------------- forward
    def forward(self, params: GNNParams, train: bool) -> torch.Tensor:
        """Log-probs, [V, C] (this rank's [owned, C] under a mesh): with
        dropout and the transposed CSR for autograd when `train`, without
        both otherwise."""
        if self.group is not None:
            return self._forward_sharded(params, train)
        return full_forward(
            params, self.family, self.x, self.csr,
            batch_norm=self.cfg.batch_norm, aggregator=self.aggregator,
            heads=self.cfg.heads, graph_t=self.csr_t if train else None,
            drop_rate=self.cfg.drop_rate if train else 0.0,
            generator=self.generator if train else None,
            x_scale=self.x_scale)

    # ------------------------------------------------------------------ run
    def train_epoch(self) -> Tuple[float, float, float, float]:
        """One forward/backward/update over the whole graph → (loss, train,
        val, test accuracy); one host sync."""
        dev = self.device
        epoch = self.epochs_run
        self.epochs_run += 1
        with span("epoch", epoch=epoch):
            with span("forward", dev):
                leaves = [p.detach().requires_grad_()
                          for p in self.params.leaves()]
                logp = self.forward(self.params.replace_leaves(leaves),
                                    train=True)
                # the masked NLL over the global train count
                # (`nll_loss_masked`'s arithmetic): under a mesh, this
                # rank's share of the global mean
                picked = logp.gather(1, self.y[:, None])[:, 0]
                loss = torch.where(self.masks[0], -picked, 0.0).sum() / (
                    self.mask_counts[0])
            with span("backward", dev):
                loss.backward()
                grads = [p.grad for p in leaves]
                if self.group is not None:
                    grads = self.group.reduce_grads(grads)
            logp = logp.detach()
            if self.cfg.drop_rate > 0.0 and self.clean_metrics:
                with span("clean_forward", dev), torch.no_grad():
                    logp = self.forward(self.params, train=False)
            with span("update", dev):
                new, self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self.params.leaves())
                self.params = self.params.replace_leaves(new)
            with span("readback"):
                correct = logp.argmax(dim=-1) == self.y
                out = torch.stack([loss.detach().float(), *(
                    (correct & m).sum().float() for m in self.masks)])
                if self.group is not None:  # the loss and the counts
                    self.group.all_reduce_sum_(out, "metrics_all_reduce")
                out[1:] /= self.mask_counts
                out = out.tolist()
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
        forward (same edge weights, AGGREGATOR, BATCH_NORM), no dropout.
        Under a mesh the sharded forward, all-gathered and mapped from
        slots to global vertex order (sgnn_tpu/train/fullbatch.py:
        906-925), on every rank."""
        logp = self.forward(self.params, train=False)
        if self.group is None:
            return logp.cpu().numpy()
        table = self.group.all_gather_rows(own_rows(logp, self.shard),
                                           "predict_all_gather")
        return table.cpu().numpy()[self.sharded.slot_of_vertex]

    def evaluate(self, nids: np.ndarray) -> float:
        """Exact whole-graph accuracy over the given vertex ids."""
        nids = np.asarray(nids)
        if nids.size == 0:
            return 0.0
        pred = np.argmax(self.predict(), axis=-1)
        labels = np.asarray(self.dataset.labels)
        return float((pred[nids] == labels[nids]).mean())

    def checkpoint_state(self) -> dict:
        """Parameters, optimizer state and the dropout generator: what a
        bit-identical resume needs (train/checkpoint.py).  Replicated over
        the ranks of a mesh: every rank draws the same masks."""
        return {"params": params_state(self.params),
                "opt_state": opt_state_dict(self.opt_state),
                "dropout_rng": self.generator.get_state()}

    def load_checkpoint_state(self, state: dict) -> None:
        self.params = load_params(state["params"], self.params)
        self.opt_state = load_opt_state(state["opt_state"], self.opt_state)
        self.generator.set_state(state["dropout_rng"])

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


def _graph_group(mesh, device) -> Optional[DataGroup]:
    """The trainer's graph group, checked: a DataGroup whose ranks all sit
    on the graph axis, on a device of the type asked for."""
    if mesh is None:
        return None
    if not isinstance(mesh, DataGroup):
        raise TypeError(f"mesh must be a graph group (parallel.mesh."
                        f"make_group(graph=n)), not {type(mesh).__name__}")
    if mesh.graph != mesh.world_size:
        raise ValueError(f"mesh has {mesh.world_size} ranks, {mesh.graph} of "
                         f"them on the graph axis: whole-graph training "
                         f"shards over every rank (make_group(graph="
                         f"{mesh.world_size}))")
    if device is not None and resolve_device(device).type != mesh.device.type:
        raise ValueError(f"device {device} is not the group's {mesh.device}")
    return mesh
