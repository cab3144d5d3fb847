"""In-memory dataset container.

Reference: GNNDatum (core/ntsDataloador.hpp:86) stores pinned host arrays
local_feature / local_label / local_mask keyed by vertex id.  The port keeps
them as plain host numpy arrays (the same container as the JAX package's),
uploaded to the device by the code that serves or trains on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Mask encoding parity with reference (ntsDataloador.hpp:1039-1047):
# train→0, val/eval→1, test→2, other→3.
MASK_TRAIN = 0
MASK_VAL = 1
MASK_TEST = 2
MASK_NONE = 3


@dataclasses.dataclass
class Dataset:
    """A whole-graph dataset: topology + features + labels + split masks."""

    num_vertices: int
    # COO edge list, shape [E, 2] int32 — column 0 = src, column 1 = dst.
    # An edge (s, d) contributes s to d's in-neighborhood (reference CSC is
    # keyed by dst with row_indices = srcs, FullyRepGraph.hpp:724).
    edges: np.ndarray
    features: Optional[np.ndarray] = None  # [V, F] float32
    labels: Optional[np.ndarray] = None    # [V] int32
    masks: Optional[np.ndarray] = None     # [V] int32 (MASK_* encoding)
    name: str = "unnamed"

    @property
    def num_edges(self) -> int:
        return int(self.edges.shape[0])

    @property
    def feature_dim(self) -> int:
        return 0 if self.features is None else int(self.features.shape[1])

    @property
    def num_classes(self) -> int:
        return 0 if self.labels is None else int(self.labels.max()) + 1

    def nids_with_mask(self, mask_value: int) -> np.ndarray:
        """Vertex ids whose split mask equals `mask_value` (e.g. MASK_TRAIN)."""
        assert self.masks is not None
        return np.nonzero(self.masks == mask_value)[0].astype(np.int32)

    def add_self_loops(self) -> "Dataset":
        """Return a dataset whose edge list includes (v, v) for every v.

        The reference ships `.edge.self` files with self-loops materialised;
        this covers datasets that ship without them.
        """
        have = self.edges[:, 0] == self.edges[:, 1]
        missing = np.setdiff1d(
            np.arange(self.num_vertices, dtype=np.int32), self.edges[have, 0]
        )
        loops = np.stack([missing, missing], axis=1).astype(np.int32)
        return dataclasses.replace(
            self, edges=np.concatenate([self.edges, loops], axis=0)
        )

    def validate(self) -> None:
        assert self.edges.ndim == 2 and self.edges.shape[1] == 2
        assert self.edges.min(initial=0) >= 0
        assert self.edges.max(initial=-1) < self.num_vertices
        if self.features is not None:
            assert self.features.shape[0] == self.num_vertices
        if self.labels is not None:
            assert self.labels.shape[0] == self.num_vertices
        if self.masks is not None:
            assert self.masks.shape[0] == self.num_vertices
