"""OGB node-property datasets → the port's Dataset, and the NTS 4-file export.

The port of sgnn_tpu/data/ogb.py.  Reference:
data/OGBData/transOGBData_To_NeutronStarData.py + run.sh +
convert2binary.cpp convert ogbn-arxiv / ogbn-products into the NTS format
(the edge binary with self-loops, and the feature, label and mask text
tables).  Heterogeneous (mag) and edge-feature-only (proteins) graphs are
not supported there or here.

The port reads an OGB directory that is already on disk (`load_ogb_dir`);
it has no download path, so `load_ogb` needs a local directory.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

from ..utils.logging import get_logger
from .dataset import Dataset, MASK_NONE, MASK_TEST, MASK_TRAIN, MASK_VAL
from .nts_format import write_edge_binary

log = get_logger("sgnn.ogb")


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)


def load_ogb_dir(root: str, name: str = "dataset") -> Dataset:
    """Load an OGB node-property dataset directory, in the layout ogb's
    `NodePropPredDataset` downloads:
      raw/edge.csv.gz, raw/node-feat.csv.gz, raw/node-label.csv.gz,
      split/<split_name>/{train,valid,test}.csv.gz
    (the first split directory by name); self-loops are added, as the
    reference conversion does."""
    raw = os.path.join(root, "raw")
    edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
    feats = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"), np.float32)
    labels = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.int64)
    v = feats.shape[0]
    masks = np.full(v, MASK_NONE, dtype=np.int32)
    split_root = os.path.join(root, "split")
    if os.path.isdir(split_root):
        sp = os.path.join(split_root, sorted(os.listdir(split_root))[0])
        for fname, code in (("train", MASK_TRAIN), ("valid", MASK_VAL),
                            ("test", MASK_TEST)):
            p = os.path.join(sp, f"{fname}.csv.gz")
            if os.path.exists(p):
                masks[_read_csv_gz(p, np.int64).ravel()] = code
    ds = Dataset(num_vertices=v, edges=edges.astype(np.int32),
                 features=feats, labels=labels.ravel().astype(np.int32),
                 masks=masks, name=name).add_self_loops()
    ds.validate()
    return ds


def load_ogb(name: str, root: Optional[str] = None) -> Dataset:
    """The OGB dataset `name` from the local directory `root`
    (`load_ogb_dir`).  The JAX package can also fetch it through the `ogb`
    package; the port never downloads, so `root=None` raises."""
    if root is None:
        raise RuntimeError(
            f"load_ogb({name!r}): the port reads a local OGB directory "
            f"(raw/ and split/, as ogb's NodePropPredDataset lays it out); "
            f"pass root= pointing at it")
    return load_ogb_dir(root, name)


_MASK_NAMES = {MASK_TRAIN: "train", MASK_VAL: "val", MASK_TEST: "test",
               MASK_NONE: "unknown"}


def export_nts_format(ds: Dataset, out_dir: str,
                      prefix: Optional[str] = None) -> str:
    """Write the reference's 4-file format: `<prefix>.<V>.edge.self`
    (binary), `.featuretable`, `.labeltable` and `.mask` (text), files a
    reference `nts` binary reads (run.sh parity).  Returns the path
    prefix."""
    os.makedirs(out_dir, exist_ok=True)
    base = os.path.join(out_dir, prefix or ds.name)
    write_edge_binary(f"{base}.{ds.num_vertices}.edge.self", ds.edges)
    with open(f"{base}.featuretable", "w") as f:
        for i in range(ds.num_vertices):
            row = " ".join(repr(float(x)) for x in ds.features[i])
            f.write(f"{i} {row}\n")
    with open(f"{base}.labeltable", "w") as f:
        for i in range(ds.num_vertices):
            f.write(f"{i} {int(ds.labels[i])}\n")
    with open(f"{base}.mask", "w") as f:
        for i in range(ds.num_vertices):
            f.write(f"{i} {_MASK_NAMES[int(ds.masks[i])]}\n")
    log.info("exported NTS-format dataset to %s.*", base)
    return base
