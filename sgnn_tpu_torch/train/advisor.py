"""Estimator-regime advisor: detect when sampled mini-batch training
degenerates into redundant near-whole-graph work (the port's copy of
sgnn_tpu/train/advisor.py, numpy only).

When one batch's bottom hop reaches most of the vertex set, an epoch of
B-seed batches recomputes the bottom layer over nearly the whole graph
once per step; whole-graph training (FULLBATCH) computes exact gradients
in one pass, and the reference's PD-cache engines compute the hot bottom
layer once per super-batch (GCN_SAMPLE_PD_CACHE.hpp:792-840).  The
degree-aware coupon-collector estimate of the device trainer's source-pad
planner gives the expected bottom-hop coverage at trainer-build time, and
the ESTIMATOR_ADVISOR cfg key selects what to do about it:

    warn  (default) — log a structured warning recommending FULLBATCH /
                      *PDCACHE, and set the trainers' `.estimator_advice`
    route           — also turn the PUSHDOWN bottom-hop composition on
                      (the engine registry then serves the hot bottom
                      layer from the precomputed aggregate and omits
                      cached destinations from sampling)
    off             — silence
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..graph.adjacency import Adjacency
from ..utils.logging import get_logger

log = get_logger("sgnn.advisor")

# warn when one batch's bottom hop is expected to reach this fraction of
# the whole vertex set (at 0.5 an epoch of B-sized batches already does
# steps/2 whole-graph bottom-layer equivalents)
COVERAGE_THRESHOLD = 0.5


def expected_hop_rows(adj: Adjacency, fanouts: Sequence[int],
                      batch_size: int) -> list:
    """Expected UNIQUE source rows per hop for one random seed batch.

    The degree-aware Poissonized coupon-collector model of the source-pad
    planner (train/device_trainer.compute_src_pads): source v is reached
    iff some sampled edge (v→d) lands in the hop, edge (v→d) sampled with
    probability (ndst/V)·min(f/indeg(d), 1)."""
    v = float(adj.num_vertices)
    dst_of_edge = np.repeat(np.arange(adj.num_vertices, dtype=np.int64),
                            np.diff(adj.indptr).astype(np.int64))
    indeg_e = np.maximum(adj.in_degree[dst_of_edge].astype(np.float64), 1.0)
    rows = []
    ndst = float(min(batch_size, adj.num_vertices))
    for f in fanouts:
        c_v = np.bincount(adj.indices.astype(np.int64),
                          weights=np.minimum(f / indeg_e, 1.0),
                          minlength=adj.num_vertices)
        uniq = float(-np.expm1(-(ndst / v) * c_v).sum()) + ndst
        uniq = min(uniq, float(adj.num_vertices))
        rows.append(uniq)
        ndst = uniq
    return rows


def advise_estimator_regime(
    adj: Adjacency,
    fanouts: Sequence[int],
    batch_size: int,
    n_train: int,
    *,
    mode: str = "warn",
    remedied: bool = False,
    context: str = "",
) -> Optional[Dict[str, float]]:
    """Estimate the sampled estimator's per-epoch redundancy; warn above
    the coverage threshold.  Returns the advice dict when the regime
    triggers (None otherwise), which the trainers keep as
    `.estimator_advice`.  `remedied=True` (the cached trainers, which ARE
    the recommendation, and the engine registry's route check) skips the
    warning but still returns the numbers."""
    if mode == "off" or not fanouts or n_train <= 0:
        return None
    # if even the worst-case bound cannot reach the threshold, skip the
    # O(E) degree-aware estimate
    worst = float(batch_size)
    for f in fanouts:
        worst = min(worst * (f + 1), float(adj.num_vertices))
    if worst < COVERAGE_THRESHOLD * adj.num_vertices:
        return None
    rows = expected_hop_rows(adj, fanouts, batch_size)
    coverage = rows[-1] / max(adj.num_vertices, 1)
    if coverage < COVERAGE_THRESHOLD:
        return None
    steps = max(-(-n_train // max(batch_size, 1)), 1)
    advice = {
        "bottom_coverage": round(coverage, 4),
        "steps_per_epoch": steps,
        "whole_graph_bottom_equivalents": round(steps * coverage, 2),
        "threshold": COVERAGE_THRESHOLD,
        "recommendation": "FULLBATCH or *PDCACHE/PUSHDOWN",
    }
    if remedied:
        return advice
    log.warning(
        "estimator regime%s: one %d-seed batch's bottom hop is expected "
        "to reach %.1f%% of all %d vertices — an epoch (%d steps) "
        "recomputes ~%.1fx whole-graph bottom-layer work.  At this "
        "coverage FULLBATCH computes EXACT gradients in one pass and "
        "the *PDCACHE engines reuse the hot bottom layer across "
        "batches.  Set ALGORITHM to a FULLBATCH/PDCACHE variant, "
        "ESTIMATOR_ADVISOR:route to turn the PUSHDOWN bottom-hop "
        "composition on, or ESTIMATOR_ADVISOR:off to silence.",
        f" ({context})" if context else "",
        batch_size, 100.0 * coverage, adj.num_vertices, steps,
        steps * coverage)
    return advice
