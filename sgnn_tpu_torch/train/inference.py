"""Exact (full-neighborhood) serving of GCN, GraphSAGE and GAT models.

The port's counterpart of `sgnn_tpu/train/inference.py`:

* `InferenceServer` keeps the graph and the features resident on the
  device.  `logprobs()` is one whole-graph pass (train/fullbatch.py);
  `query(nids)` walks the CSC L hops back from the queried vertices on the
  host, exactly as the JAX server plans it (same numpy fanout draws for the
  same `seed`), and runs the forward over just that neighborhood.
* `layerwise_inference` is one pass of a server built for the call
  (whole-graph mode) or, for graphs beyond device memory, a layer-by-layer
  pass over destination chunks with the activations on the host (chunked
  mode; the mode is picked by a device-memory estimate unless given);
  `exact_accuracy` reads either.

The graph stays the CSC arrays, used as a CSR over destinations: `rowptr`
is `adj.indptr` (int64), `col` is `adj.indices` (int32), `w` the serving
weight (f32; ones for GAT, whose attention kernel reads no weights);
bounds are checked once, on the host, at construction.  The JAX package's
window planner, 512-edge padding, power-of-two query buckets and one-hot
attention plan exist only for XLA's program memory, static shapes and
Mosaic's tiling, so the port has none of them.

GAT's whole-graph pass uses the clipped max-free exponential of the JAX
package's kernel tier (ops/gat.py); its query forward uses the same, where
the JAX query takes the max-shifted softmax: the two are equal while every
|score| < 60.

`aggregator="min"/"max"` serves GCN/SAGE models trained with those
reductions (the JAX server's AGGREGATOR): every layer transform-first,
then the elementwise extreme over each destination's in-edges
(ops/reductions.py), in `logprobs()` and in `query()` alike.

int8 residency (`dtype="int8"`) keeps the per-column quantized features
(data/quant.py) and their [F] scales on the device: `logprobs()` folds the
scales into W0 (train/fullbatch.full_forward), `query()` dequantizes the
gathered rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..data.quant import quantize_columns
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads
from ..nn.functional import BN_EPS, log_softmax
from ..ops.gat import gat_aggregate, pack_score_tables
from ..ops.segment import csr_from_numpy, spmm_csr, unique_inverse
from ..sampler.blocks import WeightKind
from ..sampler.native import gather_rows
from ..utils.logging import get_logger
from ..utils.profiling import memory_budget
from ..utils.timing import PhaseTimer
from .fullbatch import build_coo, check_ported, full_forward

log = get_logger("sgnn.infer")

_DEFAULT_WEIGHTS = {"gcn": WeightKind.GCN, "sage": WeightKind.MEAN,
                    "gat": WeightKind.NONE}


def _resident_dtype(dtype) -> torch.dtype:
    """float32, bfloat16 or int8 residency, given as a torch dtype, a
    numpy dtype or a name."""
    if dtype == "bfloat16":
        dtype = torch.bfloat16
    elif not isinstance(dtype, torch.dtype):
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8}.get(np.dtype(dtype), dtype)
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"serving residency is float32, bfloat16 or int8, "
                         f"not {dtype}")
    return dtype


def _serving_coo(adj: Adjacency, weight_kind: WeightKind, mean_style: str):
    """Full-graph (src, weight) in CSC order for exact serving (the same
    arithmetic as the JAX package's `_serving_coo`, unpadded).  MEAN with
    `mean_style="plain"` is 1/indeg; every other kind is `build_coo`'s."""
    if weight_kind == WeightKind.MEAN and mean_style == "plain":
        inv = (1.0 / np.maximum(adj.in_degree, 1)).astype(np.float32)
        return (adj.indices.astype(np.int32),
                np.repeat(inv, np.diff(adj.indptr).astype(np.int64)))
    src, _, w = build_coo(adj, weight_kind)
    return src, w


def _in_edges(indptr: np.ndarray, dsts: np.ndarray):
    """(edge_ids, dst_local) for ALL in-edges of `dsts` (ascending ids).

    `edge_ids` index the global CSC arrays (indices / serving weights);
    `dst_local` is ascending because `dsts` is ascending and each
    destination's edges are contiguous in CSC order."""
    starts = indptr[dsts]
    lens = indptr[dsts + 1] - starts
    total = int(lens.sum())
    pos = np.cumsum(lens) - lens
    edge_ids = (np.arange(total, dtype=np.int64)
                - np.repeat(pos, lens) + np.repeat(starts, lens))
    dst_local = np.repeat(np.arange(dsts.size, dtype=np.int32),
                          lens).astype(np.int32)
    return edge_ids, dst_local


def _query_forward(params: GNNParams, x_all: torch.Tensor,
                   gids0: torch.Tensor, layers, dst_rows, family: str,
                   aggregator: str = "sum", heads: int = 1,
                   x_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact forward over an L-hop query neighborhood: gather the bottom
    source rows (int8 rows dequantized by `x_scale`, as the JAX query
    does), then one full_forward layer per hop CSR (`layers`, bottom
    first; layer l's rows are layer l+1's sources, the sets are nested, and
    `dst_rows[l]` places layer l's destinations among its sources)."""
    h = x_all.index_select(0, gids0)
    if x_scale is not None:
        h = h.to(x_scale.dtype) * x_scale
    return full_forward(params, family, h, layers, aggregator=aggregator,
                        heads=heads, dst_rows=dst_rows)


class InferenceServer:
    """Serving loop with the graph and the features resident on the device.

    Construction uploads the CSR and the features once; `logprobs()` is
    then one whole-graph pass over resident tensors, `query(nids)` one pass
    over the queried vertices' L-hop neighborhood, and `update_params`
    swaps in fresh weights between passes.  `dtype=torch.bfloat16` halves
    residency (the classification head still ends in f32 log_softmax);
    `dtype="int8"` (or torch.int8 / np.int8) quarters it: the features are
    quantized per column (data/quant.py) and kept as int8 with their [F]
    f32 scales, which `logprobs()` folds into W0 and `query()` applies to
    the gathered rows.
    `family="gat"` serves GAT models with `heads` attention heads on the
    hidden layers (the last is single-head); GCN/SAGE ignore `heads`.

    `device=None` means CUDA and raises without a card; `device="cpu"`
    runs the plain PyTorch versions of the kernels.
    """

    def __init__(
        self,
        params: GNNParams,
        family: str,
        adj: Adjacency,
        features: np.ndarray,
        *,
        weight_kind: Optional[WeightKind] = None,
        heads: int = 1,
        mean_style: str = "plain",
        batch_norm: bool = False,
        aggregator: str = "sum",
        dtype=torch.float32,
        device=None,
    ) -> None:
        check_ported(family, aggregator)
        self.dtype = _resident_dtype(dtype)
        self.device = resolve_device(device)
        if weight_kind is None:
            weight_kind = _DEFAULT_WEIGHTS[family]
        features = np.asarray(features)
        if features.ndim != 2 or features.shape[0] != adj.num_vertices:
            raise ValueError(f"features {features.shape} do not match "
                             f"{adj.num_vertices} vertices")
        self.family = family
        self.heads = heads
        self.aggregator = aggregator
        self.batch_norm = batch_norm
        self.num_vertices = adj.num_vertices
        self._weight_kind = weight_kind
        self._mean_style = mean_style
        self._qrng = np.random.default_rng(0)  # query(fanout=...) draws
        _full_f32_products(self.device)
        src, w = _serving_coo(adj, weight_kind, mean_style)
        self.csr = csr_from_numpy(adj.indptr, src, w, adj.num_vertices,
                                  self.device)
        self._x_scale = None
        if self.dtype == torch.int8:
            q, scale = quantize_columns(features)
            self._x = torch.from_numpy(q).to(self.device)
            self._x_scale = torch.from_numpy(scale).to(self.device)
        else:
            self._x = torch.from_numpy(
                np.ascontiguousarray(features, np.float32)).to(
                    self.device).to(self.dtype)
        # host-side CSC + serving weights for query-neighborhood planning
        self._h_indptr = adj.indptr.astype(np.int64)
        self._h_indices = src
        self._h_w = w
        self._seen_query_shapes: set = set()
        self.update_params(params)

    @property
    def feature_bytes(self) -> int:
        """Bytes of the resident feature matrix (int8: the levels; the [F]
        f32 scales add 4·F bytes)."""
        return self._x.numel() * self._x.element_size()

    def update_params(self, params: GNNParams) -> None:
        check_heads(params, self.family, self.heads)
        self.params = params.to(self.device)

    def warmup(self, sizes=(8, 64, 512), reps: int = 1, fanout=None,
               seed: int = 0) -> int:
        """Run `reps` requests of each size, so the first real request
        finds the kernel built and the libraries initialised.  Returns the
        number of distinct (set sizes, edge counts) shapes seen for the
        first time — the port compiles nothing per shape, so this only
        reports how varied the neighborhoods were."""
        rng = np.random.default_rng(seed)
        before = len(self._seen_query_shapes)
        for s in sizes:
            n = int(min(s, self.num_vertices))
            for _ in range(reps):
                nids = rng.choice(self.num_vertices, size=n, replace=False)
                self.query(nids, fanout=fanout,
                           seed=int(rng.integers(1 << 31)))
        return len(self._seen_query_shapes) - before

    @torch.inference_mode()
    def logprobs(self, as_numpy: bool = True):
        """One exact full-graph pass: [V, classes] float32 log-probs.

        `as_numpy=False` keeps the result on the device."""
        logp = full_forward(self.params, self.family, self._x, self.csr,
                            batch_norm=self.batch_norm,
                            aggregator=self.aggregator, heads=self.heads,
                            x_scale=self._x_scale)
        return logp.cpu().numpy() if as_numpy else logp

    def predict(self) -> np.ndarray:
        """Class predictions for every vertex: [V] int."""
        return np.argmax(self.logprobs(), axis=-1)

    @torch.inference_mode()
    def query(self, nids, fanout=None, seed=None) -> np.ndarray:
        """Exact log-probs for just `nids`: [len(nids), C].

        Walks the CSC L hops back from the queried vertices on the host,
        local-reindexes each hop, and runs one forward over the resident
        features; results equal `logprobs()[nids]` up to float
        reassociation.  `fanout` (int, or one int per hop, seed hop first
        like cfg.fanout) keeps at most that many uniformly drawn in-edges
        per destination at each hop; MEAN/"plain" weights then become
        1/sampled-count, GCN weights keep their global-degree values.
        `seed` makes one call reproducible; otherwise the server's own RNG
        stream advances.  The draws are the JAX server's, in numpy."""
        if self.batch_norm:
            # whole-graph BN statistics need a full pass anyway
            return self.logprobs()[np.asarray(nids)]
        nids = np.asarray(nids, dtype=np.int64)
        if nids.size and (nids.min() < 0 or nids.max() >= self.num_vertices):
            raise ValueError(f"query ids must lie in [0, {self.num_vertices})")
        uniq, inv = np.unique(nids, return_inverse=True)
        n_layers = len(self.params.weights)
        if fanout is not None:
            fanouts = ([int(fanout)] * n_layers if np.isscalar(fanout)
                       else [int(f) for f in fanout])
            if len(fanouts) != n_layers:
                raise ValueError(
                    f"fanout needs {n_layers} entries, got {len(fanouts)}")
            rng = (np.random.default_rng(seed) if seed is not None
                   else self._qrng)
        # plan hop sets top-down: each hop's destinations are contained in
        # its sources, and its sources are the next hop's destinations
        dst_set = uniq
        plan = []
        for hop in range(n_layers):
            eids, dst_local = _in_edges(self._h_indptr, dst_set)
            if fanout is not None and eids.size:
                k = fanouts[hop]
                # keep k uniform draws per destination: rank each edge by
                # a random key within its dst segment
                order = np.lexsort((rng.random(eids.size), dst_local))
                seg_first = np.searchsorted(dst_local[order],
                                            np.arange(dst_set.size))
                pos = (np.arange(eids.size)
                       - seg_first[dst_local[order]])
                keep = np.sort(order[pos < k])  # back to CSC order
                eids, dst_local = eids[keep], dst_local[keep]
            w = self._h_w[eids]
            if (fanout is not None
                    and self._weight_kind == WeightKind.MEAN
                    and self._mean_style == "plain"):
                cnt = np.bincount(dst_local, minlength=dst_set.size)
                w = (1.0 / np.maximum(cnt[dst_local], 1)).astype(np.float32)
            src_g = self._h_indices[eids]
            src_set = np.union1d(dst_set, src_g)
            rowptr = np.zeros(dst_set.size + 1, np.int64)
            np.cumsum(np.bincount(dst_local, minlength=dst_set.size),
                      out=rowptr[1:])
            # dst_in_src: each destination's row in the source set (the sets
            # are nested), where GAT takes the destination's score half
            plan.append((src_set, rowptr,
                         np.searchsorted(src_set, src_g).astype(np.int32), w,
                         np.searchsorted(src_set, dst_set)))
            dst_set = src_set
        plan.reverse()
        self._seen_query_shapes.add(
            (tuple(p[0].size for p in plan) + (uniq.size,),
             tuple(p[2].size for p in plan)))
        layers = [csr_from_numpy(rowptr, col, w, src_set.size, self.device)
                  for src_set, rowptr, col, w, _ in plan]
        dst_rows = [torch.from_numpy(p[4]).to(self.device) for p in plan]
        gids0 = torch.from_numpy(plan[0][0]).to(self.device)
        logp = _query_forward(self.params, self._x, gids0, layers, dst_rows,
                              self.family, self.aggregator, self.heads,
                              self._x_scale)
        return logp.cpu().numpy()[inv]


def _full_f32_products(device: torch.device) -> None:
    """The precision choice of the whole package: f32 products in full f32
    on the card (TF32 keeps ~3 decimal digits; serving is held to the CPU
    pass at 1e-4).  Process-wide, like every torch.backends flag."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def whole_graph_bytes(params: GNNParams, family: str, adj: Adjacency,
                      feature_dim: int, heads: int = 1) -> int:
    """The JAX package's estimate of a whole-graph pass's device bytes
    (sgnn_tpu/train/inference.py:265-275): features, two activations of
    the widest layer and the COO at 4 bytes, plus GAT's per-edge score,
    attention and exponential buffers."""
    dims = [feature_dim] + [int(w.shape[1]) for w in params.weights]
    est = 4 * (adj.num_vertices * (feature_dim + 2 * max(dims))
               + 3 * adj.num_edges)
    if family == "gat":
        est += 4 * adj.num_edges * max(heads, 1) * 4
    return est


def layerwise_inference(
    params: GNNParams,
    family: str,
    adj: Adjacency,
    features: np.ndarray,
    *,
    weight_kind: Optional[WeightKind] = None,
    heads: int = 1,
    chunk_size: Optional[int] = None,
    mean_style: str = "plain",
    whole_graph: Optional[bool] = None,
    hbm_budget_bytes: Optional[int] = None,
    batch_norm: bool = False,
    timers: Optional[PhaseTimer] = None,
    device=None,
) -> np.ndarray:
    """Exact log-probabilities for ALL vertices: [V, classes] float32.

    `mean_style` selects the MEAN weights: "plain" = 1/indeg (what the
    sampled engines train with), "fullbatch" = the full-batch sym-norm/
    indeg hybrid.  `batch_norm` serves BN-trained models with whole-graph
    statistics.

    `whole_graph=True` is one pass with features, activations and the
    graph resident on the device (an InferenceServer built for the call).
    `whole_graph=False` is the beyond-device-memory mode: activations stay
    on the host as f32 numpy, and per layer (1) the dense transform runs
    in `chunk_size`-row blocks on the device (transform-first at every
    layer, as the JAX chunked mode), (2) each destination chunk [a, b) —
    `chunk_size` rows, 65,536 by default — gathers its UNIQUE transformed
    source rows on the host (the native `gather_rows`), uploads them and
    aggregates over its local CSR (built once, on the host, and reused by
    every layer; its columns index the unique sources) with K2 (GCN/SAGE)
    or K3 (GAT: `ts` from the unique rows, `td` from the chunk's own),
    then (3) relu/log_softmax, or with `batch_norm` whole-graph BN on the
    host after the last chunk, then relu.  Device memory then holds one
    chunk's rows, not the graph's.  GAT's chunk attention is K3's clipped
    max-free softmax, where the JAX chunked mode takes the max-shifted
    one: the two are equal while every |score| < 60.

    `whole_graph=None` picks by `whole_graph_bytes` against the device
    budget (`utils.profiling.memory_budget`: `hbm_budget_bytes`, else half
    the card's free memory, or 1 GiB on the CPU) and logs both.  `timers`
    (a PhaseTimer) receives the chunked mode's host-clock phases: "plan"
    (the edge weights, the chunks' unique sources and CSRs, once),
    "transform", "stage"
    (host gather and upload), "aggregate" (kernel and download) and
    "batch_norm"."""
    check_ported(family)
    dev = resolve_device(device)
    if weight_kind is None:
        weight_kind = _DEFAULT_WEIGHTS[family]
    if whole_graph is None:
        est = whole_graph_bytes(params, family, adj,
                                np.asarray(features).shape[1], heads)
        budget = memory_budget(dev, hbm_budget_bytes)
        whole_graph = est < budget
        log.info("layerwise_inference: whole-graph estimate %d bytes, budget "
                 "%d bytes on %s: %s mode", est, budget, dev,
                 "whole-graph" if whole_graph else "chunked")
    if whole_graph:
        return InferenceServer(params, family, adj, features,
                               weight_kind=weight_kind, heads=heads,
                               mean_style=mean_style, batch_norm=batch_norm,
                               device=dev).logprobs()
    check_heads(params, family, heads)
    _full_f32_products(dev)
    timers = timers if timers is not None else PhaseTimer()
    v = adj.num_vertices
    chunk = min(v, chunk_size or 65536)
    indptr = adj.indptr.astype(np.int64)
    # per destination chunk: its unique sources and its local CSR (checked
    # once, kept on the host, uploaded per layer)
    chunks = []
    with timers.phase("plan"):
        src_all, w_all = _serving_coo(adj, weight_kind, mean_style)
        for a in range(0, v, chunk):
            b = min(a + chunk, v)
            lo, hi = int(indptr[a]), int(indptr[b])
            uniq, inv = unique_inverse(src_all[lo:hi])
            chunks.append((a, b, uniq, csr_from_numpy(
                indptr[a:b + 1] - lo, inv, w_all[lo:hi], uniq.size, "cpu")))
    h = np.ascontiguousarray(features, np.float32)
    n_layers = len(params.weights)
    with torch.inference_mode():
        for l in range(n_layers):
            wl = params.weights[l].to(dev, torch.float32)
            last = l == n_layers - 1
            raw = batch_norm and not last   # BN after the whole layer
            hh = 1 if last else heads
            ht = np.empty((v, wl.shape[1]), np.float32)
            with timers.phase("transform"):
                for a in range(0, v, chunk):
                    ht[a:a + chunk] = torch.matmul(
                        torch.from_numpy(h[a:a + chunk]).to(dev),
                        wl).cpu().numpy()
            h_next = np.empty_like(ht)
            for a, b, uniq, csr in chunks:
                with timers.phase("stage"):
                    rows = torch.from_numpy(gather_rows(ht, uniq)).to(dev)
                    rowptr, col, w = (t.to(dev) for t in csr)
                    own = (torch.from_numpy(ht[a:b]).to(dev)
                           if family == "gat" else None)
                with timers.phase("aggregate"):
                    if family == "gat":
                        f = rows.shape[1]
                        attn = params.attn[l].to(dev, torch.float32)
                        ts, _ = pack_score_tables(rows, attn[:f, 0],
                                                  attn[f:, 0], hh)
                        _, td = pack_score_tables(own, attn[:f, 0],
                                                  attn[f:, 0], hh)
                        out, _ = gat_aggregate(rows, ts, td, rowptr, col, hh)
                        if not raw:
                            out = torch.relu(out)
                            out = log_softmax(out) if last else out
                    else:
                        out = spmm_csr(rows, rowptr, col, w)
                        if not raw:
                            out = log_softmax(out) if last else torch.relu(out)
                    h_next[a:b] = out.cpu().numpy()
            if raw:
                with timers.phase("batch_norm"):
                    # whole-graph BN in f32 with the shared BN_EPS, then the
                    # deferred relu (the JAX chunked mode's arithmetic)
                    mu = h_next.mean(axis=0, keepdims=True, dtype=np.float32)
                    var = h_next.var(axis=0, keepdims=True, dtype=np.float32)
                    h_next = np.maximum((h_next - mu) / np.sqrt(var + BN_EPS),
                                        0.0).astype(np.float32)
            h = h_next
    return h


def exact_accuracy(
    params: GNNParams,
    family: str,
    adj: Adjacency,
    features: np.ndarray,
    labels: np.ndarray,
    nids: np.ndarray,
    *,
    weight_kind: Optional[WeightKind] = None,
    heads: int = 1,
    mean_style: str = "plain",
    logp: Optional[np.ndarray] = None,
    batch_norm: bool = False,
    device=None,
) -> float:
    """Exact (full-neighborhood) accuracy on `nids`; pass `logp` to reuse a
    previous layerwise_inference result across splits."""
    nids = np.asarray(nids)
    if nids.size == 0:
        return 0.0
    if logp is None:
        logp = layerwise_inference(params, family, adj, features,
                                   weight_kind=weight_kind, heads=heads,
                                   mean_style=mean_style,
                                   batch_norm=batch_norm, device=device)
    pred = np.argmax(logp[nids], axis=1)
    return float(np.mean(pred == np.asarray(labels)[nids]))
