"""Edge-weight kinds and shape padding shared by the sampler and serving.

The sampled-block containers (`SampledBlock`, `SampledBatch`) join with the
sampled-training slice; serving needs only the weight kinds.
"""

from __future__ import annotations

import enum


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


def pad_to(n: int, multiple: int) -> int:
    """Round n up to a multiple (0 rounds up to one multiple)."""
    if n == 0:
        return multiple
    return (n + multiple - 1) // multiple * multiple
