"""Sampled-minibatch containers in the dense-fanout layout, over torch tensors.

The port's copy of sgnn_tpu/sampler/blocks.py.  Each hop is a dense
neighbor matrix instead of a ragged CSC, because fanout sampling bounds
every destination's in-edges by `fanout`:

    nbr    int32  [num_dst_pad, fanout]  — local index into this hop's src set
    weight f32    [num_dst_pad, fanout]  — edge weight, 0.0 for padded slots
    srcs   int32  [num_src_pad]          — global vertex ids of the src set
    seeds  int32  [num_dst_pad]          — global vertex ids of the dst set

Aggregation is then a gather + weighted sum over the fanout axis
(ops/aggregate.py, kernel K1 on the card).  Padded dst rows have all-zero
weights; padded src rows gather feature row 0 harmlessly (weight 0).

Layer ordering: blocks[0] is the INPUT-most hop (its `srcs` index the raw
feature matrix); blocks[-1] is the output hop whose `seeds` are the batch
train vertices.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import torch


class WeightKind(enum.Enum):
    """Edge weight schemes, parity with reference WeightType (Sum/Mean/None).

    GCN  = 1/(sqrt(outdeg(src)) * sqrt(indeg(dst)))   [ntsBaseOp.hpp:652]
    MEAN = GCN weight / (# sampled in-edges of dst)   [get_mean_weight kernel,
           cuda/ntsCUDATransferKernel.cuh:319]
    NONE = 1.0 on valid edges (GAT computes its own attention weights)
    """

    GCN = "gcn"
    MEAN = "mean"
    NONE = "none"


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """One sampled bipartite hop in dense-fanout layout (on one device)."""

    nbr: torch.Tensor        # int32 [num_dst_pad, fanout], local src indices
    weight: torch.Tensor     # f32   [num_dst_pad, fanout], 0 on invalid slots
    srcs: torch.Tensor       # int32 [num_src_pad], global ids (padded with 0)
    seeds: torch.Tensor      # int32 [num_dst_pad], global ids (padded with 0)
    dst_valid: torch.Tensor  # bool  [num_dst_pad], True for real destinations
    src_valid: torch.Tensor  # bool  [num_src_pad]
    # local index of each seed inside `srcs` (seeds always appear in srcs)
    seed_in_src: torch.Tensor  # int32 [num_dst_pad]

    @property
    def num_dst_pad(self) -> int:
        return self.nbr.shape[0]

    @property
    def num_src_pad(self) -> int:
        return self.srcs.shape[0]

    @property
    def fanout(self) -> int:
        return self.nbr.shape[1]


@dataclasses.dataclass(frozen=True)
class SampledBatch:
    """An L-hop sampled minibatch: blocks input→output + gathered payload."""

    blocks: List[SampledBlock]
    x0: torch.Tensor           # [blocks[0].num_src_pad, F] input features
    labels: torch.Tensor       # int64 [num_seed_pad]
    label_valid: torch.Tensor  # bool  [num_seed_pad]
    # hot-vertex embedding cache, for the BOTTOM hop's destinations (None
    # when the cache is off): cache_mask[d] ⇒ blocks[0].seeds[d] is cached
    # and its layer-0 pre-activation is replaced by cache_emb[cache_slot[d]]
    # (reference load_share_embedding, GCN_SAMPLE_PD_CACHE.hpp:938)
    cache_mask: Optional[torch.Tensor] = None   # bool  [blocks[0].num_dst_pad]
    cache_slot: Optional[torch.Tensor] = None   # int32 [blocks[0].num_dst_pad]
    # edges and seeds dropped by a src_pad_factor overflow (device sampler;
    # 0 with exact bounds), an int32 scalar on the batch's device
    overflow: Optional[torch.Tensor] = None
    # partial feature cache (cache/feature_cache.py), before the batch's x0
    # is assembled: x0 holds only the compacted cache-MISS rows and
    # cold_pos[i] each one's position on the bottom source axis (padding
    # entries point one past its end)
    cold_pos: Optional[torch.Tensor] = None     # int32 [num_cold_pad]

    @property
    def num_layers(self) -> int:
        return len(self.blocks)

    @property
    def seeds(self) -> torch.Tensor:
        return self.blocks[-1].seeds

    def num_sampled_edges(self) -> torch.Tensor:
        """Count of VALID sampled edges (for edges/s accounting), as a
        scalar tensor on the batch's device: reading it syncs."""
        return sum((b.weight != 0).sum() for b in self.blocks)


def pad_to(n: int, multiple: int) -> int:
    """Round n up to a multiple (0 rounds up to one multiple)."""
    if n == 0:
        return multiple
    return (n + multiple - 1) // multiple * multiple
