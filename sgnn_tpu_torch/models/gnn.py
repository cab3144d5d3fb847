"""GNN parameters: the container, its initialisation, and the carry-across.

Model structure (reference toolkits/ engines), the same in both packages:
  GCN/SAGE layer l:  X' = relu(aggregate(X_l) · W_l), log_softmax at the last
  (GCN uses symmetric-norm weights, SAGE mean weights — the only difference
  between the GCN* and GS* engines, GS_SAMPLE_ALLGPU.hpp:296).
  GAT layer l: W_l [in, out] plus an attention vector a_l [2·out, 1].

The parameters are a plain NamedTuple of tensors, as the JAX package's are a
pytree of arrays, so one layout crosses between them by `params_from_numpy`.
The sampled `model_forward` joins with the training slice; serving runs the
whole-graph forward of train/fullbatch.py.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..nn.layers import xavier_uniform_init

MODEL_FAMILIES = ("gcn", "sage", "gat")


class GNNParams(NamedTuple):
    """Per-layer weights; attn is empty for GCN/SAGE, [2F',1]-style for GAT."""

    weights: Tuple[torch.Tensor, ...]     # W_l: [in_l, out_l]
    attn: Tuple[torch.Tensor, ...]        # GAT a_l: [2*out_l, 1] (else empty)

    def to(self, device=None, dtype=None) -> "GNNParams":
        return GNNParams(
            weights=tuple(w.to(device=device, dtype=dtype) for w in self.weights),
            attn=tuple(a.to(device=device, dtype=dtype) for a in self.attn))


def init_model(
    seed: int,
    family: str,
    layer_sizes: Sequence[int],
    dtype: torch.dtype = torch.float32,
    device=None,
) -> GNNParams:
    """W: xavier-uniform (torch parity), drawn from a CPU `torch.Generator`
    seeded with `seed`, then moved to `device`.  GAT attention vectors
    `a`: zeros, as in the JAX package (gnn.py:79-80) — every layer starts
    at uniform attention.

    Torch's generator draws other numbers than `jax.random` from the same
    seed; to hold the two packages to each other, make the weights once
    (numpy, or the JAX package's `init_model`) and carry them across with
    `params_from_numpy`."""
    if family not in MODEL_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    ws, atts = [], []
    for i in range(len(layer_sizes) - 1):
        ws.append(xavier_uniform_init(gen, layer_sizes[i], layer_sizes[i + 1],
                                      dtype=dtype).to(dev))
        if family == "gat":
            atts.append(torch.zeros((2 * layer_sizes[i + 1], 1), dtype=dtype,
                                    device=dev))
    return GNNParams(weights=tuple(ws), attn=tuple(atts))


def params_from_numpy(weights, attn=(), device=None) -> GNNParams:
    """The JAX package's parameters, given as numpy arrays (or anything
    `np.asarray` takes), as the port's: same layout, same dtype, on
    `device`.  This is the carry-across every parity test uses."""
    dev = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    return GNNParams(weights=tuple(conv(w) for w in weights),
                     attn=tuple(conv(a) for a in attn))
