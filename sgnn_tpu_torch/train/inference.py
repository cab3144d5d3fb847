"""Exact (full-neighborhood) serving of GCN, GraphSAGE and GAT models.

The port's counterpart of `sgnn_tpu/train/inference.py`:

* `InferenceServer` keeps the graph and the features resident on the
  device.  `logprobs()` is one whole-graph pass (train/fullbatch.py);
  `query(nids)` walks the CSC L hops back from the queried vertices on the
  host, exactly as the JAX server plans it (same numpy fanout draws for the
  same `seed`), and runs the forward over just that neighborhood.
* `layerwise_inference` (whole-graph mode) and `exact_accuracy` are one
  pass of a server built for the call.

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

Not ported yet, and raising NotImplementedError with the ROADMAP.md item:
int8 residency, and the chunked beyond-device-memory mode of
`layerwise_inference` (`whole_graph=False`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..graph.adjacency import Adjacency
from ..models.gnn import GNNParams, check_heads
from ..ops.segment import csr_from_numpy
from ..sampler.blocks import WeightKind
from .fullbatch import build_coo, check_ported, full_forward

_DEFAULT_WEIGHTS = {"gcn": WeightKind.GCN, "sage": WeightKind.MEAN,
                    "gat": WeightKind.NONE}


def _resident_dtype(dtype) -> torch.dtype:
    """float32 or bfloat16 residency, given as a torch dtype, a numpy
    dtype or a name; int8 residency is not ported yet."""
    if dtype == "bfloat16":
        dtype = torch.bfloat16
    elif not isinstance(dtype, torch.dtype):
        dtype = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int8): torch.int8}.get(np.dtype(dtype), dtype)
    if dtype == torch.int8:
        raise NotImplementedError(
            "int8 feature residency is not ported yet: ROADMAP.md Queue 1 "
            "item 4 (serving extras)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"serving residency is float32 or bfloat16, "
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
                   aggregator: str = "sum", heads: int = 1) -> torch.Tensor:
    """Exact forward over an L-hop query neighborhood: gather the bottom
    source rows, then one full_forward layer per hop CSR (`layers`, bottom
    first; layer l's rows are layer l+1's sources, the sets are nested, and
    `dst_rows[l]` places layer l's destinations among its sources)."""
    return full_forward(params, family, x_all.index_select(0, gids0), layers,
                        aggregator=aggregator, heads=heads,
                        dst_rows=dst_rows)


class InferenceServer:
    """Serving loop with the graph and the features resident on the device.

    Construction uploads the CSR and the features once; `logprobs()` is
    then one whole-graph pass over resident tensors, `query(nids)` one pass
    over the queried vertices' L-hop neighborhood, and `update_params`
    swaps in fresh weights between passes.  `dtype=torch.bfloat16` halves
    residency (the classification head still ends in f32 log_softmax).
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
        if self.device.type == "cuda":
            # the precision choice of the whole package: f32 products in
            # full f32 (TF32 keeps ~3 decimal digits; serving is held to the
            # CPU pass at 1e-4).  Process-wide, like every torch.backends flag.
            torch.backends.cuda.matmul.allow_tf32 = False
        src, w = _serving_coo(adj, weight_kind, mean_style)
        self.csr = csr_from_numpy(adj.indptr, src, w, adj.num_vertices,
                                  self.device)
        self._x = torch.from_numpy(
            np.ascontiguousarray(features, np.float32)).to(
                self.device).to(self.dtype)
        # host-side CSC + serving weights for query-neighborhood planning
        self._h_indptr = adj.indptr.astype(np.int64)
        self._h_indices = src
        self._h_w = w
        self._seen_query_shapes: set = set()
        self.update_params(params)

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
                            aggregator=self.aggregator, heads=self.heads)
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
                              self.family, self.aggregator, self.heads)
        return logp.cpu().numpy()[inv]


def layerwise_inference(
    params: GNNParams,
    family: str,
    adj: Adjacency,
    features: np.ndarray,
    *,
    weight_kind: Optional[WeightKind] = None,
    heads: int = 1,
    mean_style: str = "plain",
    whole_graph: Optional[bool] = None,
    batch_norm: bool = False,
    device=None,
) -> np.ndarray:
    """Exact log-probabilities for ALL vertices: [V, classes] float32.

    The whole-graph mode of the JAX function: one pass with features,
    activations and the graph resident on the device.  `mean_style`
    selects the MEAN weights: "plain" = 1/indeg (what the sampled engines
    train with), "fullbatch" = the full-batch sym-norm/indeg hybrid.
    `batch_norm` serves BN-trained models with whole-graph statistics.
    The chunked beyond-device-memory mode (`whole_graph=False`) is not
    ported yet."""
    if whole_graph is False:
        raise NotImplementedError(
            "chunked layerwise_inference(whole_graph=False) is not ported "
            "yet: ROADMAP.md Queue 1 item 4 (serving extras)")
    return InferenceServer(params, family, adj, features,
                           weight_kind=weight_kind, heads=heads,
                           mean_style=mean_style, batch_norm=batch_norm,
                           device=device).logprobs()


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
