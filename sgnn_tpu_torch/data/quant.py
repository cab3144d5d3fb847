"""Per-column symmetric int8 feature quantization (FEATURE_DTYPE:int8).

The port's copy of sgnn_tpu/data/quant.py, numpy only: on the same input
it returns the same bits.

A capacity feature, not a speed feature: the feature matrix stored as int8
fits 4x the rows of float32 (2x of bfloat16) in the same device memory,
which multiplies the graph size that trains or serves with resident
features.

Per-COLUMN scales (scale[f] = max_v |x[v, f]| / 127) rather than per-row:
  * dequantization commutes with row aggregation and with the layer-0
    matmul (Agg(Q)·diag(s) and (Q·diag(s))·W = Q·(s⊙W)), so the scale can
    be applied to tiny tensors instead of to every gathered row, and
  * no [V]-sized scale array rides along every feature gather — the [F]
    vector is a few KB.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_columns(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """features [V, F] float → (q int8 [V, F], scale float32 [F]).

    Symmetric per-column: q = round(x / scale), scale = colmax(|x|)/127.
    All-zero columns get scale 1 (q stays 0).  Exact for binary/integer
    features with ≤127 distinct magnitude steps (e.g. Cora's bag-of-words).
    """
    x = np.asarray(features, dtype=np.float32)
    absmax = np.max(np.abs(x), axis=0)
    scale = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[None, :]), -127, 127).astype(np.int8)
    return q, scale


def dequantize(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """Host-side inverse (tests / reference values)."""
    return q.astype(np.float32) * scale[None, :].astype(np.float32)
