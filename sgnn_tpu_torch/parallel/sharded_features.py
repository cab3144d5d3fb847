"""Row-sharded feature storage for the sampled path.

The port of sgnn_tpu/parallel/sharded_features.py.  Reference: ntsPeerRPC
remote feature rows (core/ntsPeerRPC.hpp:154), used by the distributed
minibatch ops through `get_feature_from_global`
(core/ntsMiniBatchGraphOp.hpp:92): the feature matrix is partitioned
across workers and each minibatch fetches exactly the rows it sampled.

Each rank holds ceil(V_pad / n) rows instead of V_pad.  A batch's sampled
source rows are fetched with three collectives of the data-parallel
group:
  1. all_gather of the (small, int32) request ids — every owner sees every
     rank's requests;
  2. the owner-side gather of the rows it holds, zero elsewhere;
  3. a reduce-scatter of the [n, chunk, F] response stack — each rank
     receives the sum of every owner's contribution, that is its own rows.
The response stack is cut into chunks of `chunk` requests to bound its
memory.  Every rank must call this the same number of times with the same
request count: the collectives pair up across ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import DataGroup


def fetch_feature_rows(feat_local: torch.Tensor, src_global: torch.Tensor,
                       group: DataGroup, chunk: int = 4096) -> torch.Tensor:
    """Rows `src_global` ([S] int32 global vertex ids, the same S on every
    rank) of the matrix whose rank-r shard `feat_local` holds rows
    [r·rows, (r+1)·rows).  Returns [S, F] in feat_local's dtype; ids
    outside [0, n·rows) give zero rows (padding-safe).

    The collectives are `all_gather_into_tensor` and
    `reduce_scatter_tensor`, the names both the CPU's and the card's torch
    have (newer releases call them deprecated aliases of `*_single`)."""
    rows, f_dim = feat_local.shape
    n = group.world_size
    s = src_global.shape[0]
    dev = feat_local.device
    offset = group.rank * rows
    reqs = torch.empty(n * s, dtype=torch.int32, device=dev)
    dist.all_gather_into_tensor(reqs, src_global.to(torch.int32).contiguous())
    chunk = max(1, min(chunk, s))
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    reqs = reqs.view(n, s)
    if pad:
        reqs = torch.cat([reqs, torch.full((n, pad), -1, dtype=torch.int32,
                                           device=dev)], dim=1)
    out = torch.empty(n_chunks * chunk, f_dim, dtype=feat_local.dtype,
                      device=dev)
    zero = torch.zeros((), dtype=feat_local.dtype, device=dev)
    for c in range(n_chunks):
        rel = reqs[:, c * chunk:(c + 1) * chunk].long() - offset
        mine = (rel >= 0) & (rel < rows)
        vals = feat_local.index_select(0, rel.clamp(0, rows - 1).reshape(-1))
        contrib = torch.where(mine.reshape(-1, 1), vals, zero)   # [n·chunk, F]
        # reduce-scatter: rank q receives Σ_p contrib_p[q] = its rows
        dist.reduce_scatter_tensor(out[c * chunk:(c + 1) * chunk], contrib,
                                   op=dist.ReduceOp.SUM)
    return out[:s]
