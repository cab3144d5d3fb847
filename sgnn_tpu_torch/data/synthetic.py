"""Synthetic graph generators for tests and benchmarks.

The same numpy draws as `sgnn_tpu/data/synthetic.py`, in the same order, so
a fixed seed gives bit-identical arrays in both packages (the parity tests
hold them equal).  The reference has `GNNDatum::random_generate`
(core/ntsDataloador.hpp:835) for runs without feature files.
"""

from __future__ import annotations

import numpy as np

from .dataset import Dataset, MASK_TRAIN, MASK_VAL, MASK_TEST


def _attach_random_payload(
    ds: Dataset, feature_dim: int, num_classes: int, rng: np.random.Generator,
    train_frac: float = 0.66, val_frac: float = 0.1,
) -> Dataset:
    v = ds.num_vertices
    ds.features = rng.standard_normal((v, feature_dim), dtype=np.float32)
    ds.labels = rng.integers(0, num_classes, size=v).astype(np.int32)
    masks = np.full(v, MASK_TEST, dtype=np.int32)
    n_train = int(v * train_frac)
    n_val = int(v * val_frac)
    perm = rng.permutation(v)
    masks[perm[:n_train]] = MASK_TRAIN
    masks[perm[n_train:n_train + n_val]] = MASK_VAL
    ds.masks = masks
    return ds


def random_graph_dataset(
    num_vertices: int,
    avg_degree: int,
    feature_dim: int,
    num_classes: int,
    seed: int = 0,
    self_loops: bool = True,
    name: str = "synthetic-er",
) -> Dataset:
    """Erdős–Rényi-style random digraph with uniform degrees."""
    rng = np.random.default_rng(seed)
    e = num_vertices * avg_degree
    src = rng.integers(0, num_vertices, size=e, dtype=np.int64)
    dst = rng.integers(0, num_vertices, size=e, dtype=np.int64)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    ds = Dataset(num_vertices=num_vertices, edges=edges, name=name)
    if self_loops:
        ds = ds.add_self_loops()
    return _attach_random_payload(ds, feature_dim, num_classes, rng)


def powerlaw_graph_dataset(
    num_vertices: int,
    avg_degree: int,
    feature_dim: int,
    num_classes: int,
    alpha: float = 0.8,
    seed: int = 0,
    self_loops: bool = True,
    name: str = "synthetic-powerlaw",
) -> Dataset:
    """Digraph with Zipf-skewed endpoints: a small vertex set is "hot"
    (the regime of NeutronOrch's hotness-aware cache, reference
    core/ntsBaseOp.hpp:409 preSample).  Half the edges are mirrored so the
    hubs are hot on both sides."""
    rng = np.random.default_rng(seed)
    e = num_vertices * avg_degree
    # Zipf-ish sampling via inverse-CDF on ranks
    u = rng.random(e)
    ranks = np.floor(num_vertices * u ** (1.0 / (1.0 - alpha))).astype(np.int64)
    ranks = np.clip(ranks, 0, num_vertices - 1)
    # ranks → ids through a permutation: the hot vertices spread over ids
    perm = rng.permutation(num_vertices)
    src = perm[ranks]
    dst = rng.integers(0, num_vertices, size=e, dtype=np.int64)
    half = e // 2
    src[:half], dst[:half] = dst[:half].copy(), src[:half].copy()
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    ds = Dataset(num_vertices=num_vertices, edges=edges, name=name)
    if self_loops:
        ds = ds.add_self_loops()
    return _attach_random_payload(ds, feature_dim, num_classes, rng)


def planted_community_dataset(
    num_vertices: int,
    avg_degree: int,
    feature_dim: int,
    num_classes: int,
    intra_frac: float = 0.7,
    alpha: float = 0.8,
    feature_snr: float = 1.0,
    seed: int = 0,
    name: str = "synthetic-sbm",
    label_noise: float = 0.0,
) -> Dataset:
    """Power-law degrees + planted communities → learnable labels at scale.

    Labels are community ids; `intra_frac` of each vertex's edges stay
    inside its community and features are a noisy community centroid.
    Source endpoints follow a Zipf-ish rank draw, so in- and out-degrees
    are skewed.  `label_noise` flips that fraction of the observed labels
    to a uniform random class, capping reachable accuracy near
    (1-ρ) + ρ/C.
    """
    rng = np.random.default_rng(seed)
    v = num_vertices
    comm = rng.integers(0, num_classes, size=v).astype(np.int32)
    # order vertices by community for fast intra-community endpoint draws
    order = np.argsort(comm, kind="stable")
    sorted_comm = comm[order]
    starts = np.searchsorted(sorted_comm, np.arange(num_classes))
    ends = np.searchsorted(sorted_comm, np.arange(num_classes), side="right")
    e = v * avg_degree
    u = rng.random(e)
    ranks = np.clip(
        np.floor(v * u ** (1.0 / (1.0 - alpha))).astype(np.int64), 0, v - 1
    )
    perm = rng.permutation(v)
    src = perm[ranks]
    # destinations: intra-community with prob intra_frac, else uniform
    intra = rng.random(e) < intra_frac
    c = comm[src]
    lo, hi = starts[c], ends[c]
    intra_dst = order[
        (lo + (rng.random(e) * np.maximum(hi - lo, 1)).astype(np.int64)).clip(
            0, v - 1
        )
    ]
    rand_dst = rng.integers(0, v, size=e)
    dst = np.where(intra, intra_dst, rand_dst)
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    ds = Dataset(num_vertices=v, edges=edges, name=name).add_self_loops()
    # features: community centroid + gaussian noise
    centroids = rng.standard_normal((num_classes, feature_dim)).astype(np.float32)
    noise = rng.standard_normal((v, feature_dim)).astype(np.float32)
    ds.features = centroids[comm] * feature_snr + noise
    labels = comm.copy()
    if label_noise > 0:
        flip = rng.random(v) < label_noise
        labels[flip] = rng.integers(0, num_classes, size=int(flip.sum()))
    ds.labels = labels
    masks = np.full(v, MASK_TEST, dtype=np.int32)
    p = rng.permutation(v)
    masks[p[: int(v * 0.66)]] = MASK_TRAIN
    masks[p[int(v * 0.66): int(v * 0.76)]] = MASK_VAL
    ds.masks = masks
    return ds


def calibrated_reddit_like_dataset(seed: int = 0, scale: float = 1.0) -> Dataset:
    """Reddit-shaped accuracy anchor with a calibrated Bayes ceiling.

    The shape of `reddit_like_dataset` (602 features, 41 classes, power-law
    degrees) with 20% of observed labels flipped (ceiling ≈ 0.805), weak
    features (snr 0.2) and mixed communities (intra 0.55), so reaching the
    ceiling takes correct neighborhood aggregation.
    """
    v = max(1024, int(232965 * scale))
    return planted_community_dataset(
        v, 50, feature_dim=602, num_classes=41,
        intra_frac=0.55, feature_snr=0.2, label_noise=0.2,
        seed=seed, name="reddit-like-calibrated",
    )


def reddit_like_dataset(seed: int = 0, scale: float = 1.0) -> Dataset:
    """A Reddit-shaped synthetic benchmark graph.

    Reddit: 232,965 vertices with 602 features and 41 classes; `scale`
    shrinks the vertex count and keeps the degree structure (50 drawn
    in-edges per vertex on average, plus self-loops: about 11.9M edges at
    scale 1).  The reference benchmarks GCN/SAGE on Reddit with layers
    602-128-41 (gcn_reddit_sample.cfg:1-19).
    """
    v = max(1024, int(232965 * scale))
    deg = 50  # sampled workloads only see fanout-bounded neighborhoods
    # planted-community model so benchmark accuracy is a real signal
    return planted_community_dataset(
        v, deg, feature_dim=602, num_classes=41,
        feature_snr=0.5, seed=seed, name="reddit-like",
    )
