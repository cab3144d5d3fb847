"""The benchmark's graph: a frozen copy of the port's planted-community
generator, cached in a fixed directory inside the checkout.

`planted_community` is the numpy code of
`sgnn_tpu_torch/data/synthetic.planted_community_dataset` with
`Dataset.add_self_loops`, draw for draw: a configuration's graph
seed gives the same arrays as `reddit_like_dataset(seed, scale)` at the
same sizes.  It is copied so that no later change to the program changes
the graph the benchmark trains on.  The graph depends only on the
configuration's `graph` group, never on a run's `--seed`.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
CACHE_DIR = ROOT / "build" / "benchmark" / "graphs"

# split encoding of the port's Dataset (train 0, val 1, test 2)
MASK_TRAIN, MASK_VAL, MASK_TEST = 0, 1, 2
ARRAYS = ("edges", "features", "labels", "masks")


def planted_community(vertices: int, avg_in_degree: int, features: int,
                      classes: int, intra_frac: float, alpha: float,
                      feature_snr: float, seed: int, train_frac: float,
                      val_end_frac: float) -> Dict[str, np.ndarray]:
    """Power-law sources and planted communities: labels are community
    ids, `intra_frac` of the edges stay inside the source's community,
    features are the community's centroid times `feature_snr` plus unit
    noise; a self-loop is added to every vertex without one.  The split:
    the first `train_frac` of a permutation train, up to `val_end_frac`
    validation, the rest test."""
    rng = np.random.default_rng(seed)
    v = vertices
    comm = rng.integers(0, classes, size=v).astype(np.int32)
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(classes))
    ends = np.searchsorted(sorted_comm, np.arange(classes), side="right")
    e = v * avg_in_degree
    u = rng.random(e)
    ranks = np.clip(
        np.floor(v * u ** (1.0 / (1.0 - alpha))).astype(np.int64), 0, v - 1)
    perm = rng.permutation(v)
    src = perm[ranks]
    intra = rng.random(e) < intra_frac
    c = comm[src]
    lo, hi = starts[c], ends[c]
    intra_dst = order[
        (lo + (rng.random(e) * np.maximum(hi - lo, 1)).astype(np.int64)).clip(
            0, v - 1)]
    rand_dst = rng.integers(0, v, size=e)
    dst = np.where(intra, intra_dst, rand_dst)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    have = edges[:, 0] == edges[:, 1]
    missing = np.setdiff1d(np.arange(v, dtype=np.int32), edges[have, 0])
    loops = np.stack([missing, missing], axis=1).astype(np.int32)
    edges = np.concatenate([edges, loops], axis=0)
    centroids = rng.standard_normal((classes, features)).astype(np.float32)
    noise = rng.standard_normal((v, features)).astype(np.float32)
    feats = centroids[comm] * feature_snr + noise
    masks = np.full(v, MASK_TEST, dtype=np.int32)
    p = rng.permutation(v)
    masks[p[:int(v * train_frac)]] = MASK_TRAIN
    masks[p[int(v * train_frac):int(v * val_end_frac)]] = MASK_VAL
    return {"edges": edges, "features": feats, "labels": comm.copy(),
            "masks": masks}


GENERATORS = {"planted_community": planted_community}


def cache_key(graph_cfg: dict) -> str:
    """A fixed directory name for a graph configuration: its generator and
    parameters, hashed."""
    text = json.dumps(graph_cfg, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def load_graph(graph_cfg: dict, cache_dir: Path = CACHE_DIR
               ) -> Dict[str, np.ndarray]:
    """The configuration's graph arrays, from the cache when they are
    there, else generated and written there (each file replaced whole)."""
    d = Path(cache_dir) / f"{graph_cfg['generator']}-{cache_key(graph_cfg)}"
    files = {k: d / f"{k}.npy" for k in ARRAYS}
    if all(f.exists() for f in files.values()):
        return {k: np.load(f) for k, f in files.items()}
    params = {k: v for k, v in graph_cfg.items() if k != "generator"}
    arrays = GENERATORS[graph_cfg["generator"]](**params)
    d.mkdir(parents=True, exist_ok=True)
    for k, f in files.items():
        tmp = f.with_name(f"{k}.partial.npy")
        np.save(tmp, arrays[k])
        os.replace(tmp, f)
    return arrays
