"""Hotness pre-sampling: rank vertices by expected sampling frequency.

The port's copy of sgnn_tpu/cache/hotness.py, numpy only: on the same
inputs it returns the same arrays, and it reads and writes the same
`<edge>.sgnn_pre_sample_*.bin` files, so either package reads a file the
other wrote.

Reference: nts::op::preSample (core/ntsBaseOp.hpp:409/:427) — per super-
batch, propagate visit counts L-1 hops from the train vertices over the
full CSC (get_most_neighbor :267/:332), sort by count, take the top
cache_rate fraction as the hot-vertex cache; persist the result and reload
it on later runs (:432-541).  nts_local_shuffle (:73/:145) keeps
super-batch membership stable across epochs while still shuffling within
each super-batch.  The count propagation is numpy bincount passes with the
fanout-clamped expected-visit model.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..graph.adjacency import Adjacency
from ..utils.io import read_binary
from ..utils.logging import get_logger

log = get_logger("sgnn.cache")

_MAGIC = 0x53474E4E  # "SGNN"


def _dst_of_edge(adj: Adjacency) -> np.ndarray:
    """The destination of every CSC edge, int64 [E]."""
    return np.repeat(np.arange(adj.num_vertices, dtype=np.int64),
                     np.diff(adj.indptr).astype(np.int64))


def hotness_scores(adj: Adjacency, train_nids: np.ndarray,
                   fanouts: Sequence[int],
                   dst_of_edge: Optional[np.ndarray] = None) -> np.ndarray:
    """Expected visit counts per vertex under fanout sampling from the
    train nids.  Hop h spreads each destination's count over its
    in-neighbors, scaled by min(fanout_h, deg)/deg (the probability mass
    fanout sampling puts on each in-edge), the reference preSample's
    counting model.  `dst_of_edge` may be passed in to skip its O(E)
    rebuild (per-SB planning)."""
    v = adj.num_vertices
    frontier = np.zeros(v, dtype=np.float64)
    frontier[train_nids] = 1.0
    deg = np.maximum(adj.in_degree.astype(np.float64), 1.0)
    total = np.zeros(v, dtype=np.float64)
    if dst_of_edge is None:
        dst_of_edge = _dst_of_edge(adj)
    for f in fanouts:
        per_edge = frontier * (np.minimum(float(f), deg) / deg)
        # each edge (src -> dst) adds the destination's mass to its source
        nxt = np.bincount(adj.indices.astype(np.int64),
                          weights=per_edge[dst_of_edge], minlength=v)
        total += nxt
        frontier = nxt
    return total


def _write_ids(path: str, header, ids: np.ndarray) -> None:
    """[magic, *header] uint32, then the ids as uint32: written to a
    temporary file and renamed, so a reader never sees half a file."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(np.concatenate([np.array([_MAGIC, *header], dtype="<u4"),
                                ids.astype("<u4").ravel()]).tobytes())
    os.replace(tmp, path)


def presample_hotness(adj: Adjacency, train_nids: np.ndarray,
                      fanouts: Sequence[int], cache_rate: float,
                      edge_file: Optional[str] = None,
                      batch_size: int = 0) -> np.ndarray:
    """The top cache_rate·V hottest vertex ids, persisted beside
    `edge_file` as `<edge>.sgnn_pre_sample_b{B}_f{fanouts}.bin` ([magic,
    n] uint32 header, then the ids).  The name omits the rate (the
    reference's convention), so a file holding fewer ids than asked for
    is regenerated, not truncated."""
    n_cache = int(adj.num_vertices * cache_rate)
    if n_cache == 0:
        return np.zeros(0, dtype=np.int32)
    path = None
    if edge_file:
        fan_s = "-".join(str(f) for f in fanouts)
        path = f"{edge_file}.sgnn_pre_sample_b{batch_size}_f{fan_s}.bin"
        if os.path.exists(path):
            raw = read_binary(path, dtype="<u4")
            if (raw.size >= 2 and raw[0] == _MAGIC
                    and raw[1] == raw.size - 2 and raw.size - 2 >= n_cache):
                log.info("presample: loaded %d hot ids from %s",
                         raw.size - 2, path)
                return raw[2:].astype(np.int32)[:n_cache]
    scores = hotness_scores(adj, train_nids, fanouts)
    ids = np.argsort(-scores, kind="stable")[:n_cache].astype(np.int32)
    if path:
        _write_ids(path, [ids.size], ids)
        log.info("presample: wrote %d hot ids to %s", ids.size, path)
    return ids


def super_batch_stable_shuffle(nids: np.ndarray, super_batch_size: int,
                               rng: np.random.Generator) -> np.ndarray:
    """Shuffle WITHIN super-batches, keeping their membership stable
    across epochs (reference nts_local_shuffle, ntsBaseOp.hpp:73/:145):
    the hot-vertex cache is planned per super-batch."""
    out = np.array(nids, copy=True)
    for s in range(0, len(out), super_batch_size):
        seg = out[s:s + super_batch_size]
        rng.shuffle(seg)
        out[s:s + super_batch_size] = seg
    return out


def presample_hotness_per_sb(adj: Adjacency, train_nids: np.ndarray,
                             fanouts: Sequence[int], cache_rate: float,
                             super_batch_size: int,
                             edge_file: Optional[str] = None,
                             batch_size: int = 0) -> np.ndarray:
    """Per-SUPER-BATCH hot sets: [n_sb, C] int32 vertex ids.

    Reference preSample ranks hotness per super-batch and installs a
    different cache index per SB (batch_cache_num, ntsBaseOp.hpp:427-541;
    new_cache_var/set_cache_index, ntsDataloador.hpp:285/:440): a vertex
    hot for SB k's seeds may be cold for SB k+1's.  Membership follows the
    stable super-batch partition, so the plan computed once stays valid.
    Persisted as `..._psb{n_sb}.bin` ([magic, n_sb, C] header)."""
    c = int(adj.num_vertices * cache_rate)
    n_sb = max(-(-len(train_nids) // super_batch_size), 1)
    if c == 0:
        return np.zeros((n_sb, 0), dtype=np.int32)
    path = None
    if edge_file:
        fan_s = "-".join(str(f) for f in fanouts)
        path = (f"{edge_file}.sgnn_pre_sample_b{batch_size}_f{fan_s}"
                f"_psb{n_sb}.bin")
        if os.path.exists(path):
            raw = read_binary(path, dtype="<u4")
            if (raw.size >= 3 and raw[0] == _MAGIC
                    and raw[1] * raw[2] == raw.size - 3):
                ids = raw[3:].astype(np.int32).reshape(raw[1], raw[2])
                if ids.shape[0] == n_sb and ids.shape[1] >= c:
                    log.info("presample: loaded %dx%d per-SB hot ids from "
                             "%s", ids.shape[0], c, path)
                    return ids[:, :c]
    per = np.zeros((n_sb, c), dtype=np.int32)
    doe = _dst_of_edge(adj)
    for k in range(n_sb):
        sb = train_nids[k * super_batch_size:(k + 1) * super_batch_size]
        scores = hotness_scores(adj, sb, fanouts, dst_of_edge=doe)
        per[k] = np.argsort(-scores, kind="stable")[:c].astype(np.int32)
    if path:
        _write_ids(path, [n_sb, c], per)
        log.info("presample: wrote %dx%d per-SB hot ids to %s", n_sb, c,
                 path)
    return per
