#!/usr/bin/env python3
"""Time the chunked `layerwise_inference` plan's unique-source step on the
host, three ways, over every destination chunk of a synthetic CSR:

  numpy     `np.unique(ids, return_inverse=True)` (a sort of the chunk's
            edges),
  presence  a [V] presence map, its prefix sum and `flatnonzero` per chunk
            (O(V) a chunk, so O(V^2 / chunk) a plan),
  keysort   `inference._unique_inverse`: one value sort of (id, position)
            keys, O(edges log edges) a chunk.

    python3 scripts/torch_chunk_plan_time.py [--vertices V --degree D]
                                             [--chunk C] [--reps R]

With no --vertices it runs two shapes: Reddit's (232,965 vertices, 51
sources a row, 4 chunks) and a graph of 10^7 vertices with 8 sources a row
(153 chunks).  Sources are uniform; every row has the same degree.  CPU
only (numpy); prints one JSON line a shape with the best of R plans in
seconds, after checking that the three give the same arrays.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sgnn_tpu_torch.train.inference import _unique_inverse  # noqa: E402


def _numpy(ids, v):
    uniq, inv = np.unique(ids, return_inverse=True)
    return uniq.astype(np.int32), inv.astype(np.int32)


def _presence(ids, v):
    present = np.zeros(v, bool)
    present[ids] = True
    rank = np.cumsum(present, dtype=np.int32) - 1
    return np.flatnonzero(present).astype(np.int32), rank[ids]


def _keysort(ids, v):
    return _unique_inverse(ids)


METHODS = {"numpy": _numpy, "presence": _presence, "keysort": _keysort}


def time_shape(v: int, degree: int, chunk: int, reps: int) -> dict:
    src = np.random.default_rng(0).integers(0, v, v * degree,
                                            dtype=np.int32)
    bounds = [(a * degree, min(a + chunk, v) * degree)
              for a in range(0, v, chunk)]
    first = [m(src[slice(*bounds[0])], v) for m in METHODS.values()]
    for uniq, inv in first[1:]:
        np.testing.assert_array_equal(uniq, first[0][0])
        np.testing.assert_array_equal(inv, first[0][1])
    out = {"vertices": v, "degree": degree, "chunk": chunk,
           "chunks": len(bounds), "edges": int(src.size)}
    for name, m in METHODS.items():
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for lo, hi in bounds:
                m(src[lo:hi], v)
            best = min(best, time.perf_counter() - t0)
        out[f"{name}_s"] = best
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--vertices", type=int)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=65536)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    shapes = ([(args.vertices, args.degree)] if args.vertices else
              [(232965, 51), (10_000_000, 8)])
    for v, d in shapes:
        print(json.dumps(time_shape(v, d, args.chunk, args.reps)),
              flush=True)


if __name__ == "__main__":
    main()
