"""Readers/writers for the reference's on-disk dataset formats.

Formats (verified against shipped Cora files and reference readers):
  - edge binary:  little-endian uint32 (src, dst) pairs, no header
                  (reference Graph::load_directed core/graph.hpp:1129 and
                  FullyRepGraph::ReadRepGraphFromRawFile FullyRepGraph.hpp:724)
  - featuretable: text, per line `id f0 f1 ... f_{D-1}`
  - labeltable:   text, per line `id label`
  - mask:         text, per line `id train|val|eval|test|other`
                  (reference GNNDatum::readFeature_Label_Mask
                   core/ntsDataloador.hpp:999-1062)
"""

from __future__ import annotations

import os
import zipfile
from typing import Optional

import numpy as np

from .dataset import Dataset, MASK_TRAIN, MASK_VAL, MASK_TEST, MASK_NONE

_MASK_CODES = {"train": MASK_TRAIN, "val": MASK_VAL, "eval": MASK_VAL,
               "test": MASK_TEST}


def read_edge_binary(path: str, num_vertices: Optional[int] = None) -> np.ndarray:
    """Read a binary (src, dst) uint32 edge list → [E, 2] int32."""
    from ..utils.io import read_binary

    raw = read_binary(path, dtype="<u4")
    if raw.size % 2 != 0:
        raise ValueError(f"{path}: odd number of uint32 words, not an edge pair file")
    edges = raw.reshape(-1, 2).astype(np.int32)
    if num_vertices is not None and edges.size and edges.max() >= num_vertices:
        raise ValueError(
            f"{path}: max vertex id {edges.max()} >= VERTICES {num_vertices}"
        )
    return edges


def write_edge_binary(path: str, edges: np.ndarray) -> None:
    """Write [E, 2] (src, dst) pairs as little-endian uint32 words, the
    format `read_edge_binary` reads."""
    with open(path, "wb") as f:
        f.write(np.asarray(edges, dtype=np.uint32).astype("<u4").tobytes())


def read_feature_table(path: str, num_vertices: int, feature_dim: int) -> np.ndarray:
    """Read `id f0 ... f_{D-1}` lines into a dense [V, D] float32 matrix.

    Rows may appear in any vertex-id order (the reference reader is id-keyed).
    """
    with open(path) as f:
        flat = np.array(f.read().split(), dtype=np.float32)
    rows = flat.reshape(-1, feature_dim + 1)
    if rows.shape[0] != num_vertices:
        raise ValueError(
            f"{path}: {rows.shape[0]} rows, expected {num_vertices}"
        )
    ids = rows[:, 0].astype(np.int64)
    out = np.zeros((num_vertices, feature_dim), dtype=np.float32)
    out[ids] = rows[:, 1:]
    return out


def read_label_table(path: str, num_vertices: int) -> np.ndarray:
    rows = np.loadtxt(path, dtype=np.int64).reshape(-1, 2)
    out = np.zeros(num_vertices, dtype=np.int32)
    out[rows[:, 0]] = rows[:, 1].astype(np.int32)
    return out


def read_mask_table(path: str, num_vertices: int) -> np.ndarray:
    out = np.full(num_vertices, MASK_NONE, dtype=np.int32)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            out[int(parts[0])] = _MASK_CODES.get(parts[1], MASK_NONE)
    return out


def _maybe_unzip(path: str) -> str:
    """The reference ships cora.featuretable.zip; transparently extract."""
    if os.path.exists(path):
        return path
    zpath = path + ".zip"
    if os.path.exists(zpath):
        with zipfile.ZipFile(zpath) as z:
            z.extractall(os.path.dirname(path))
        if os.path.exists(path):
            return path
    raise FileNotFoundError(path)


def load_nts_dataset(
    edge_file: str,
    feature_file: str,
    label_file: str,
    mask_file: str,
    num_vertices: int,
    feature_dim: int,
    name: str = "nts",
) -> Dataset:
    """Load a dataset in the reference's 4-file format."""
    ds = Dataset(
        num_vertices=num_vertices,
        edges=read_edge_binary(edge_file, num_vertices),
        features=read_feature_table(_maybe_unzip(feature_file), num_vertices, feature_dim),
        labels=read_label_table(label_file, num_vertices),
        masks=read_mask_table(mask_file, num_vertices),
        name=name,
    )
    ds.validate()
    return ds


def load_from_config(cfg) -> Dataset:
    """Load the dataset named by a RunConfig (reference cfg file parity)."""
    return load_nts_dataset(
        cfg.edge_file,
        cfg.feature_file,
        cfg.label_file,
        cfg.mask_file,
        num_vertices=cfg.vertices,
        feature_dim=cfg.layer_sizes[0],
        name=os.path.basename(cfg.edge_file),
    )
