"""Graph-partition parallelism: vertex-sharded whole-graph layers.

The port of sgnn_tpu/parallel/halo.py.  Reference: the NeutronStar
distributed full-batch path — Gemini vertex-range partitioning with
master/mirror replicas; per-layer feature exchange master→mirror forward
and gradient mirror→master backward over MPI send/recv threads
(Graph::process_edges_forward/backward_decoupled, core/graph.hpp:2535-3530;
DistGetDepNbrOp etc., core/ntsDistCPUGraphOp.hpp:34-524; SURVEY.md §3.5).

Vertices are range-sharded over the ranks of a graph group
(parallel/mesh.make_group(graph=n)), one process a shard.  The JAX package
runs every shard in one `shard_map` program; here a layer is two parts:

1. the exchange, a `torch.autograd.Function` whose backward is the
   transpose of its forward:
   - all_gather halo: the [rows, F] shard → the [n·rows, F] slot table
     (master→mirror fetch); backward reduce_scatter(SUM) of the table's
     gradient to its owners (mirror→master push);
   - targeted halo: x_shard[send_idx] → all_to_all → [own ‖ recv-from-0 ‖
     …] (only the mirror rows each pair needs); backward the reverse
     all_to_all, then each received gradient added into the rows sent, per
     destination rank in rank order and only over the real rows — a row
     sent to several ranks sums in one fixed order, with no float atomics;
2. the shard-local layer over the shard's CSR (destinations its local
   rows, sources the exchanged rows): K2 through `SpmmCsr` (its backward
   over the CSR's transpose), the attention through `GatAggregate` (K3,
   K4); min/max is `segment_extreme` over the same CSR (the trainer's).

The host plans keep the JAX names and slot layout (`ShardedGraph`,
`shard_graph`, `TargetedHalo`, `build_targeted_halo`), but each shard is a
CSR and not JAX's padded COO: no E_pad, no perm/inv_perm and no windowed
planner, which exist for XLA's static shapes; the port's kernels read
`rowptr`.  A rank uploads only its own shard (`shard_on_device`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.adjacency import Adjacency
from ..graph.partition import degree_balanced_ranges
from ..ops.gat import GatAggregate, gat_aggregate, pack_score_tables
from ..ops.segment import (
    Csr, SpmmCsr, csr_from_numpy, csr_transpose, spmm_csr,
)
from ..sampler.blocks import pad_to
from ..utils.logging import get_logger
from .mesh import DataGroup

log = get_logger("sgnn.halo")


class ShardedGraph(NamedTuple):
    """Vertex-range-sharded in-edges, one CSR a shard (host numpy).

    Shard p owns the contiguous global vertex range [offsets[p],
    offsets[p+1]) and lays it out in SLOT space: global vertex g lives at
    slot `slot_of_vertex[g] = p·rows + (g - offsets[p])`, so every
    vertex-indexed array is a uniform [n·rows, ...] whatever the ranges'
    sizes (degree-balanced ranges are ragged).  Shard p's CSR has one row a
    local slot (rows past the owned count have no edges) and holds every
    in-edge of its owned vertices in the graph's CSC order: sources are
    SLOT ids, resolved against the all-gathered slot table."""

    offsets: np.ndarray                  # [n+1] int64 owned-range bounds
    slot_of_vertex: np.ndarray           # [V] int64 global vertex → slot
    rowptr: Tuple[np.ndarray, ...]       # per shard [rows+1] int64
    src: Tuple[np.ndarray, ...]          # per shard [E_p] int32 SLOT ids
    weight: Tuple[np.ndarray, ...]       # per shard [E_p] f32
    rows_per_shard: int                  # owned-vertex count padded to 8

    @property
    def num_parts(self) -> int:
        return int(self.offsets.shape[0] - 1)

    @property
    def num_src(self) -> int:
        """Rows of the table a shard's sources index: the slot table."""
        return self.num_parts * self.rows_per_shard

    @property
    def shard_meta(self) -> np.ndarray:
        """[n, 2] int32 (global range start, owned count) per shard: where
        a shard's dropout rows start and how many of its rows are real."""
        sizes = np.diff(self.offsets)
        return np.stack([self.offsets[:-1], sizes], axis=1).astype(np.int32)

    def shard_csr(self, p: int):
        """Shard p's (rowptr, source ids, weights)."""
        return self.rowptr[p], self.src[p], self.weight[p]


def shard_graph(adj: Adjacency, num_parts: int, weights: np.ndarray,
                balance: str = "equal") -> ShardedGraph:
    """Partition in-edges by destination owner (contiguous vertex ranges).

    balance="degree" (FullBatchTrainer's default, PARTITION_BALANCE):
    ranges balanced by the α·V + E cost model over in-degrees (tune_chunks,
    core/graph.hpp:1837; graph/partition.degree_balanced_ranges), so each
    shard's edge count tends to E/n instead of being set by the hub
    shard.  balance="equal": equal vertex ranges, slots equal to global
    ids.  `weights` are the graph's edge weights in CSC order
    (train/fullbatch.build_coo)."""
    v = adj.num_vertices
    if balance == "degree":
        offsets = degree_balanced_ranges(adj.in_degree, num_parts)
        rows = pad_to(max(int(np.diff(offsets).max()), 1), 8)
    elif balance == "equal":
        rows = pad_to((v + num_parts - 1) // num_parts, 8)
        offsets = np.minimum(np.arange(num_parts + 1) * rows, v)
    else:
        raise ValueError(
            f"balance must be 'degree' or 'equal', got {balance!r}")
    offsets = offsets.astype(np.int64)
    slot_of_vertex = np.empty(v, np.int64)
    rowptrs, srcs, ws = [], [], []
    weights = np.asarray(weights, np.float32)
    for p in range(num_parts):
        s, e = int(offsets[p]), int(offsets[p + 1])
        slot_of_vertex[s:e] = p * rows + np.arange(e - s, dtype=np.int64)
    for p in range(num_parts):
        s, e = int(offsets[p]), int(offsets[p + 1])
        lo, hi = int(adj.indptr[s]), int(adj.indptr[e])
        rp = np.full(rows + 1, hi - lo, np.int64)
        rp[: e - s + 1] = adj.indptr[s:e + 1] - lo
        rowptrs.append(rp)
        srcs.append(slot_of_vertex[adj.indices[lo:hi]].astype(np.int32))
        ws.append(weights[lo:hi])
    log.info("shard_graph(%s): %d shards x %d rows, edge counts %s", balance,
             num_parts, rows, [s.size for s in srcs])
    return ShardedGraph(offsets=offsets, slot_of_vertex=slot_of_vertex,
                        rowptr=tuple(rowptrs), src=tuple(srcs),
                        weight=tuple(ws), rows_per_shard=rows)


class TargetedHalo(NamedTuple):
    """Static per-pair halo exchange plan (all_to_all, not broadcast).

    The all_gather halo ships every owner's whole shard to every rank; the
    targeted one ships each rank only its mirror set, as the reference's
    per-partition message buffers (NtsGraphCommunicator,
    comm/network.cpp:476-790): one all_to_all a layer, then the shard's
    CSR resolves its sources against [own rows ‖ received rows].

    send_idx[p, q, i] = LOCAL row (within p's shard) of the i-th vertex p
    sends to q, for i < send_cnt[p, q] (0 past it).  On rank q the own
    rows occupy [0, rows) of the concat space and the rows received from p
    [rows + p·H_pad, rows + p·H_pad + send_cnt[p, q]); `src_local` are
    shard q's edge sources in that space."""

    send_idx: np.ndarray                 # [n, n, H_pad] int32 (owner, needer)
    send_cnt: np.ndarray                 # [n, n] int64 real rows of each pair
    rowptr: Tuple[np.ndarray, ...]       # per shard [rows+1] int64
    src_local: Tuple[np.ndarray, ...]    # per shard [E_p] int32 concat ids
    weight: Tuple[np.ndarray, ...]       # per shard [E_p] f32
    rows_per_shard: int
    halo_pad: int

    @property
    def num_parts(self) -> int:
        return int(self.send_idx.shape[0])

    @property
    def num_src(self) -> int:
        """Rows of the concat space a shard's sources index."""
        return self.rows_per_shard + self.num_parts * self.halo_pad

    def shard_csr(self, p: int):
        return self.rowptr[p], self.src_local[p], self.weight[p]


def build_targeted_halo(adj: Adjacency, num_parts: int, weights: np.ndarray,
                        balance: str = "equal") -> TargetedHalo:
    """Host construction of the static all_to_all plan, in SLOT space
    (`shard_graph`'s layout): a slot's owner is slot // rows and its local
    row slot - owner·rows, for equal and degree-balanced ranges alike.
    H_pad is the largest pair's row count padded to 8."""
    sg = shard_graph(adj, num_parts, weights, balance=balance)
    rows, n = sg.rows_per_shard, num_parts
    # per (q, p): the sorted unique slots q needs from p
    need = [[np.zeros(0, np.int64)] * n for _ in range(n)]
    h_pad = 1
    for q in range(n):
        srcs_q = sg.src[q].astype(np.int64)
        remote = np.unique(srcs_q[srcs_q // rows != q])
        cut = np.searchsorted(remote, np.arange(n + 1) * rows)
        for p in range(n):
            need[q][p] = remote[cut[p]:cut[p + 1]]
            h_pad = max(h_pad, need[q][p].size)
    h_pad = pad_to(h_pad, 8)
    send_idx = np.zeros((n, n, h_pad), np.int32)
    send_cnt = np.zeros((n, n), np.int64)
    src_local = []
    for q in range(n):
        lookup = np.zeros(n * rows, np.int64)
        lookup[q * rows:(q + 1) * rows] = np.arange(rows)
        for p in range(n):
            u = need[q][p]
            send_idx[p, q, : u.size] = (u - p * rows).astype(np.int32)
            send_cnt[p, q] = u.size
            lookup[u] = rows + p * h_pad + np.arange(u.size)
        src_local.append(lookup[sg.src[q]].astype(np.int32))
    return TargetedHalo(send_idx=send_idx, send_cnt=send_cnt,
                        rowptr=sg.rowptr, src_local=tuple(src_local),
                        weight=sg.weight, rows_per_shard=rows,
                        halo_pad=h_pad)


@dataclasses.dataclass
class Shard:
    """One rank's part of a plan on its device: its CSR (rows = its local
    slots, sources = the exchanged rows), the CSR's transpose that the
    backward runs over (None for min/max), and for the targeted halo its
    send plan: `send_idx` [n, H_pad] int64, row q the local rows it sends
    rank q, `send_cnt` the real ones of each row."""

    rows: int
    csr: Csr
    csr_t: Optional[Csr]
    send_idx: Optional[torch.Tensor] = None
    send_cnt: Tuple[int, ...] = ()


def shard_on_device(plan, part: int, device=None,
                    transpose: bool = True) -> Shard:
    """Upload shard `part` of a ShardedGraph (all_gather halo) or a
    TargetedHalo, with its transposed CSR (`ops/segment.csr_transpose`)
    when `transpose`."""
    rowptr, col, w = plan.shard_csr(part)
    rows = plan.rows_per_shard
    csr = csr_from_numpy(rowptr, col, w, plan.num_src, device)
    csr_t = None
    if transpose:
        csr_t = csr_from_numpy(*csr_transpose(rowptr, col, w, plan.num_src),
                               rows, device)
    if isinstance(plan, TargetedHalo):
        return Shard(rows, csr, csr_t,
                     torch.from_numpy(plan.send_idx[part].astype(np.int64)
                                      ).to(csr.rowptr.device),
                     tuple(int(c) for c in plan.send_cnt[part]))
    return Shard(rows, csr, csr_t)


# ------------------------------------------------------------- exchanges --
class _AllGatherHalo(torch.autograd.Function):
    """all_gather of the shard forward, reduce_scatter(SUM) backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter_rows(g), None


class _TargetedHalo(torch.autograd.Function):
    """x[send_idx] → all_to_all → [x ‖ received] forward; the reverse
    all_to_all and the per-rank, in-order adds backward."""

    @staticmethod
    def forward(ctx, x, send_idx, send_cnt, group):
        n, h = send_idx.shape
        feat = x.shape[1]
        send = x.index_select(0, send_idx.reshape(-1)).view(n, h, feat)
        recv = group.all_to_all_rows(send)
        ctx.save_for_backward(send_idx)
        ctx.send_cnt, ctx.group, ctx.rows = send_cnt, group, x.shape[0]
        return torch.cat([x, recv.view(n * h, feat)])

    @staticmethod
    def backward(ctx, g):
        (send_idx,) = ctx.saved_tensors
        n, h = send_idx.shape
        rows = ctx.rows
        g = g.contiguous()
        back = ctx.group.all_to_all_rows(g[rows:].view(n, h, g.shape[1]))
        dx = g[:rows].clone()
        # rank q's gradient of the rows sent to it; a row sent to several
        # ranks gathers its terms in rank order (index_copy_ over unique
        # rows: no atomics, the same sum on every run)
        for q, cnt in enumerate(ctx.send_cnt):
            if cnt:
                idx = send_idx[q, :cnt]
                dx.index_copy_(0, idx, dx.index_select(0, idx) + back[q, :cnt])
        return dx, None, None, None


class _AllReduceSum(torch.autograd.Function):
    """all_reduce(SUM) forward and backward: every rank's result is the sum
    of every rank's input, so each input's gradient is the sum of every
    rank's output gradient."""

    @staticmethod
    def forward(ctx, t, group, tag):
        ctx.group, ctx.tag = group, tag
        return group.all_reduce_sum_(t.clone(), tag)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_sum_(g.clone(), ctx.tag), None, None


def all_reduce_sum(t: torch.Tensor, group: DataGroup,
                   tag: Optional[str] = None) -> torch.Tensor:
    """The sum over the ranks of `t`, differentiable (synchronized batch
    norm's statistics)."""
    return _AllReduceSum.apply(t, group, tag)


def all_gather_halo(x_shard: torch.Tensor, group: DataGroup) -> torch.Tensor:
    """The [n·rows, F] slot table of every rank's [rows, F] shard."""
    return _AllGatherHalo.apply(x_shard, group)


def targeted_halo_exchange(x_shard: torch.Tensor, shard: Shard,
                           group: DataGroup) -> torch.Tensor:
    """[own rows ‖ recv-from-0 ‖ recv-from-1 …], [rows + n·H_pad, F]:
    exactly the mirror rows this shard's edges read."""
    return _TargetedHalo.apply(x_shard, shard.send_idx, shard.send_cnt,
                               group)


def own_rows(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's rows as the [rows, ...] shard: `t` holds its real rows
    first, at most `shard.rows` of them, and zero rows fill the rest (the
    sharded trainer keeps only the real rows between layers)."""
    pad = shard.rows - t.shape[0]
    if pad < 0:
        raise ValueError(f"{t.shape[0]} rows for a shard of {shard.rows}")
    return t if pad == 0 else F.pad(t, (0, 0, 0, pad))


def halo_exchange(x_own: torch.Tensor, shard: Shard,
                  group: DataGroup) -> torch.Tensor:
    """The rows the shard's CSR reads, from this rank's rows `x_own`
    (`own_rows`): the targeted exchange for a shard with a send plan, the
    all_gather otherwise."""
    x_shard = own_rows(x_own, shard)
    if shard.send_idx is not None:
        return targeted_halo_exchange(x_shard, shard, group)
    return all_gather_halo(x_shard, group)


def exchange_reference(plan, part: int, x_slot: torch.Tensor
                       ) -> torch.Tensor:
    """What the exchange delivers to shard `part` from the whole [n·rows, F]
    slot-layout table, computed in one process (the exchange's plain
    version, for checks): the table itself for the all_gather halo, own
    rows ‖ each owner's sent rows (padding rows too) for the targeted
    one."""
    if not isinstance(plan, TargetedHalo):
        return x_slot
    rows = plan.rows_per_shard
    idx = [np.arange(part * rows, (part + 1) * rows)]
    idx += [p * rows + plan.send_idx[p, part].astype(np.int64)
            for p in range(plan.num_parts)]
    return x_slot.index_select(0, torch.from_numpy(np.concatenate(idx)).to(
        x_slot.device))


# -------------------------------------------------- shard-local layers --
def _needs_transpose(shard: Shard, *inputs: torch.Tensor) -> None:
    if (shard.csr_t is None and torch.is_grad_enabled()
            and any(t.requires_grad for t in inputs)):
        raise ValueError("a shard-local layer under autograd needs the "
                         "shard's transposed CSR (shard_on_device("
                         "transpose=True))")


def local_aggregate(ext: torch.Tensor, shard: Shard) -> torch.Tensor:
    """[rows, F]: the weighted sum over the shard's CSR of the exchanged
    rows — K2 (`SpmmCsr`, its backward over the transpose)."""
    _needs_transpose(shard, ext)
    if shard.csr_t is None:
        return spmm_csr(ext, *shard.csr)
    return SpmmCsr.apply(ext, *shard.csr, *shard.csr_t)


def local_gat(ext: torch.Tensor, ts_ext: torch.Tensor, td: torch.Tensor,
              shard: Shard, heads: int) -> torch.Tensor:
    """[rows, F] attention aggregation (pre-activation) of the exchanged
    transformed rows `ext` into the shard's rows: K3 through
    `GatAggregate` (K4 backward), with the score tables of the exchanged
    rows (`ts_ext`, sources) and of the shard's own rows (`td` [rows, H],
    destinations).  Every destination's softmax is shard-local, as its
    in-edges all live on its owner (DistEdgeSoftMax)."""
    _needs_transpose(shard, ext, ts_ext, td)
    if shard.csr_t is None:
        return gat_aggregate(ext, ts_ext, td, shard.csr.rowptr,
                             shard.csr.col, heads)[0]
    return GatAggregate.apply(ext, ts_ext, td, shard.csr.rowptr,
                              shard.csr.col, shard.csr_t.rowptr,
                              shard.csr_t.col, heads)


def sharded_aggregate(x_own: torch.Tensor, shard: Shard,
                      group: DataGroup) -> torch.Tensor:
    """One partition-parallel aggregation with the all_gather halo, [rows,
    F], of this rank's rows `x_own` (real rows first, `own_rows`)."""
    return local_aggregate(all_gather_halo(own_rows(x_own, shard), group),
                           shard)


def sharded_aggregate_targeted(x_own: torch.Tensor, shard: Shard,
                               group: DataGroup) -> torch.Tensor:
    """One partition-parallel aggregation with the targeted halo: traffic
    n·H_pad·F instead of the all_gather's n·rows·F."""
    return local_aggregate(targeted_halo_exchange(own_rows(x_own, shard),
                                                  shard, group), shard)


def sharded_gat_layer(ht: torch.Tensor, attn: torch.Tensor, shard: Shard,
                      group: DataGroup, heads: int = 1) -> torch.Tensor:
    """One partition-parallel GAT aggregation, [rows, F], of this rank's
    transformed rows `ht` = h·W (real rows first, `own_rows`; the caller's
    product, where the JAX function takes h and W).  Each owner computes
    its rows' score tables (`pack_score_tables`, as the single-device
    layer) and sends the source half with the rows; the attention then
    runs shard-locally (`local_gat`).  The JAX layer computes the source
    half from the exchanged rows instead: the same table, as a row's score
    depends on that row alone."""
    f = ht.shape[1]
    ts, td = pack_score_tables(ht, attn[:f, 0].to(ht.dtype),
                               attn[f:, 0].to(ht.dtype), heads)
    ext = halo_exchange(ht, shard, group)
    ts_ext = halo_exchange(ts, shard, group)
    return local_gat(ext, ts_ext, own_rows(td, shard), shard, heads)
