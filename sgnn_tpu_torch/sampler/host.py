"""Host-side fanout neighbor sampler producing fixed-shape dense blocks.

The port's copy of sgnn_tpu/sampler/host.py: the same hop loop, the same
`np.random.default_rng(seed)` drawn in the same order, so for one seed its
blocks equal the JAX package's bit for bit.  Reference:
FastSampler::sample_fast (core/ntsFastSampler.hpp:962) — per-hop BFS over
the whole-graph CSC: clamp fanout, draw distinct edge positions per
destination, dedup sources, local-reindex, compute edge weights.

Two backends: the native C++/OpenMP sampler (sampler/native, exact draws
without replacement from a counter-based RNG; the default) and numpy
(`exact=True`: Floyd-style choice per row, slow, for tests; `exact=False`:
with-replacement draw + in-row dedup, duplicate slots masked out).  Unlike
the JAX package, `use_native=True` raises when the library cannot be
built, instead of switching to numpy, which draws other numbers.

Degree modes: "global" weights from full-graph degrees, "sampled" from the
degrees of the sampled subgraph (ReFreshDegree/UpdateDegree,
cuda/ntsCUDATransferKernel.cuh:228-290).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..graph.adjacency import Adjacency
from .blocks import WeightKind, pad_to

# every padded extent (dst rows, src rows) is a multiple of this, as in the
# JAX package's default
PAD_MULTIPLE = 128


@dataclasses.dataclass
class _HopPlan:
    """Static shapes for one hop (fixed across batches)."""

    fanout: int
    num_dst_pad: int
    num_src_pad: int


class HostSampler:
    """Layer-wise fanout sampler over a host-resident whole-graph CSC.

    One instance per (graph, seed-set, fanout, batch_size); call
    `sample(batch_seeds)` per minibatch."""

    def __init__(
        self,
        adj: Adjacency,
        fanouts: Sequence[int],
        batch_size: int,
        weight_kind: WeightKind = WeightKind.GCN,
        degree_mode: str = "global",
        exact: bool = False,
        seed: int = 0,
        use_native: bool = True,
    ) -> None:
        self.adj = adj
        # fanouts given seed-hop first (cfg order "25-10", fanout[0] applies
        # to the seed batch, ntsFastSampler.hpp:1003); blocks come out
        # reversed, input→output
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.weight_kind = weight_kind
        self.degree_mode = degree_mode
        self.exact = exact
        self.rng = np.random.default_rng(seed)
        self.use_native = use_native
        if use_native:
            from .native import load_library

            load_library()   # raises here, not mid-epoch, if g++ fails
        self._lookup = np.zeros(adj.num_vertices, dtype=np.int32)
        self.plans = self._make_plans()

    # ---------------------------------------------------------------- plans
    def _make_plans(self) -> List[_HopPlan]:
        v_pad = pad_to(self.adj.num_vertices, PAD_MULTIPLE)
        plans: List[_HopPlan] = []
        ndst = pad_to(self.batch_size, PAD_MULTIPLE)
        for f in self.fanouts:
            # src set = sampled neighbors ∪ seeds, bounded by dst*(f+1) and V
            nsrc = min(pad_to(ndst * (f + 1), PAD_MULTIPLE), v_pad)
            plans.append(_HopPlan(fanout=f, num_dst_pad=ndst, num_src_pad=nsrc))
            ndst = nsrc  # next hop's dst set is this hop's src set
        return plans

    # ------------------------------------------------------------- sampling
    def _draw_positions(self, deg: np.ndarray,
                        fanout: int) -> Tuple[np.ndarray, np.ndarray]:
        """Sample ≤fanout edge positions per row, without replacement:
        (pos[B, fanout] int64, valid[B, fanout] bool).  Rows with
        deg <= fanout take all positions (ntsFastSampler.hpp:1041-1049)."""
        slot = np.arange(fanout, dtype=np.int64)[None, :]
        take_all = deg[:, None] <= fanout
        valid = slot < deg[:, None]
        pos = np.where(take_all,
                       np.minimum(slot, np.maximum(deg[:, None] - 1, 0)), 0)
        big = np.nonzero(deg > fanout)[0]
        if big.size:
            if self.exact:
                for i in big:
                    pos[i] = self.rng.choice(deg[i], size=fanout, replace=False)
            else:
                # with-replacement draw + in-row dedup (duplicates masked out)
                draws = (self.rng.random((big.size, fanout))
                         * deg[big, None]).astype(np.int64)
                draws.sort(axis=1)
                dup = np.zeros_like(draws, dtype=bool)
                dup[:, 1:] = draws[:, 1:] == draws[:, :-1]
                pos[big] = draws
                valid[big] = ~dup
        return pos, valid

    def _sample_hop(self, seeds: np.ndarray, fanout: int):
        """One hop: seeds (global ids) → (nbr_global[B,f], valid[B,f])."""
        indptr, indices = self.adj.indptr, self.adj.indices
        start = indptr[seeds]
        deg = (indptr[seeds + 1] - start).astype(np.int64)
        pos, valid = self._draw_positions(deg, fanout)
        nbr_global = indices[np.minimum(start[:, None] + pos, indptr[-1] - 1)]
        return np.where(valid, nbr_global, -1), valid

    def sample(self, batch_seeds: np.ndarray,
               omit_map: Optional[np.ndarray] = None) -> "HostSampledBatch":
        """Sample an L-hop block stack for `batch_seeds` (≤ batch_size ids).

        `omit_map` ([V] int32, slot or -1): destinations of the BOTTOM hop
        with a cache slot are not expanded — the cache-omitting sampler
        (reference sample_gpu_fast_omit, ntsFastSampler.hpp:711) —
        shrinking the sampling work and the bottom hop's source set.  The
        draws stay those of the sampler without it."""
        if self.use_native:
            from .native import sample_batch

            return sample_batch(self, np.asarray(batch_seeds, dtype=np.int32),
                                omit_map)
        return self._sample_numpy(batch_seeds, omit_map)

    def _sample_numpy(self, batch_seeds: np.ndarray,
                      omit_map: Optional[np.ndarray] = None
                      ) -> "HostSampledBatch":
        hops = []  # seed-hop first
        seeds = np.asarray(batch_seeds, dtype=np.int32)
        nseed = seeds.shape[0]
        last = len(self.plans) - 1
        for h, plan in enumerate(self.plans):
            nbr_global, valid = self._sample_hop(seeds.astype(np.int64),
                                                 plan.fanout)
            if omit_map is not None and h == last:
                valid = valid & (omit_map[seeds] < 0)[:, None]
                nbr_global = np.where(valid, nbr_global, -1)
            # src set = unique valid neighbors ∪ seeds (guarantees
            # seed_in_src exists; reference merge-src-dst mode coocsc.hpp:407)
            srcs = np.union1d(np.unique(nbr_global[valid]),
                              seeds).astype(np.int32)
            if srcs.size and srcs[0] < 0:
                srcs = srcs[srcs >= 0]
            # local reindex (reference src_index_array, ntsFastSampler.hpp:1075)
            self._lookup[srcs] = np.arange(srcs.size, dtype=np.int32)
            nbr_local = np.where(valid,
                                 self._lookup[np.maximum(nbr_global, 0)], 0)
            hops.append(dict(
                seeds=seeds, nbr_global=nbr_global, nbr_local=nbr_local,
                valid=valid, srcs=srcs, seed_in_src=self._lookup[seeds],
                plan=plan))
            seeds = srcs  # expand next hop from this hop's src set
        return self._finalize(hops, nseed)

    # ------------------------------------------------------ weights/padding
    def _hop_weights(self, hop: dict) -> np.ndarray:
        """Edge weights per WeightKind/degree_mode (see module docstring)."""
        valid = hop["valid"]
        nbrg = np.maximum(hop["nbr_global"], 0)
        seeds = hop["seeds"].astype(np.int64)
        if self.weight_kind == WeightKind.NONE:
            return valid.astype(np.float32)
        if self.degree_mode == "global" and self.weight_kind == WeightKind.MEAN:
            # plain mean (1/sampled-count), as the device sampler: the JAX
            # package's deliberate deviation from the reference's global-
            # degree mean hybrids (sgnn_tpu/sampler/device.py:41-49)
            div = np.maximum(valid.sum(axis=1), 1)
            return np.where(valid, 1.0 / div[:, None], 0.0).astype(np.float32)
        if self.degree_mode == "sampled":
            # in_degree[dst] = # sampled in-edges (0 → fanout, UpdateDegree
            # kernel parity); out_degree[src] = # sampled out-edges this hop
            samp_in = valid.sum(axis=1).astype(np.int64)
            samp_in = np.where(samp_in == 0, hop["plan"].fanout, samp_in)
            counts = np.bincount(hop["nbr_local"][valid].ravel(),
                                 minlength=hop["srcs"].size)
            out_deg = counts[hop["nbr_local"]]
            w = 1.0 / (np.sqrt(np.maximum(out_deg, 1))
                       * np.sqrt(samp_in)[:, None])
        else:
            od = np.maximum(self.adj.out_degree[nbrg], 1)
            idg = np.maximum(self.adj.in_degree[seeds], 1)
            w = 1.0 / (np.sqrt(od) * np.sqrt(idg)[:, None])
        if self.weight_kind == WeightKind.MEAN:
            # sampled-degree mean divides by the sampled edge count (GPU
            # get_mean_weight kernel, ntsCUDATransferKernel.cuh:319-343)
            w = w / np.maximum(valid.sum(axis=1), 1)[:, None]
        return np.where(valid, w, 0.0).astype(np.float32)

    def _finalize(self, hops: List[dict], nseed: int) -> "HostSampledBatch":
        """Pad hops to plan shapes and reverse into input→output order."""
        blocks = []
        for hop in hops:
            plan: _HopPlan = hop["plan"]
            nd, ns = hop["seeds"].shape[0], hop["srcs"].shape[0]
            if ns > plan.num_src_pad:
                raise RuntimeError(
                    f"src overflow: {ns} > {plan.num_src_pad}; raise pad cap")
            w = hop.get("weight")
            if w is None:  # the native path computes weights in C++
                w = self._hop_weights(hop)
            nbr = np.zeros((plan.num_dst_pad, plan.fanout), dtype=np.int32)
            wgt = np.zeros((plan.num_dst_pad, plan.fanout), dtype=np.float32)
            seeds_p = np.zeros(plan.num_dst_pad, dtype=np.int32)
            sis_p = np.zeros(plan.num_dst_pad, dtype=np.int32)
            srcs_p = np.zeros(plan.num_src_pad, dtype=np.int32)
            nbr[:nd] = hop["nbr_local"]
            wgt[:nd] = w
            seeds_p[:nd] = hop["seeds"]
            sis_p[:nd] = hop["seed_in_src"]
            srcs_p[:ns] = hop["srcs"]
            dstv = np.zeros(plan.num_dst_pad, dtype=bool)
            dstv[:nd] = True
            srcv = np.zeros(plan.num_src_pad, dtype=bool)
            srcv[:ns] = True
            blocks.append(HostBlock(
                nbr=nbr, weight=wgt, srcs=srcs_p, seeds=seeds_p,
                dst_valid=dstv, src_valid=srcv, seed_in_src=sis_p,
                num_dst=nd, num_src=ns))
        blocks.reverse()  # input→output order
        return HostSampledBatch(blocks=blocks, num_seeds=nseed)

    # ------------------------------------------------------------ epoch iter
    def epoch_seed_batches(self, train_nids: np.ndarray, shuffle: bool = True):
        """Yield per-step seed arrays; the last partial batch is padded by
        the plan."""
        nids = np.asarray(train_nids, dtype=np.int32)
        if shuffle:
            nids = self.rng.permutation(nids)
        for i in range(0, nids.shape[0], self.batch_size):
            yield nids[i:i + self.batch_size]


@dataclasses.dataclass
class HostBlock:
    """Host-side (numpy) mirror of SampledBlock + actual sizes."""

    nbr: np.ndarray
    weight: np.ndarray
    srcs: np.ndarray
    seeds: np.ndarray
    dst_valid: np.ndarray
    src_valid: np.ndarray
    seed_in_src: np.ndarray
    num_dst: int
    num_src: int

    def num_valid_edges(self) -> int:
        return int((self.weight != 0).sum())


@dataclasses.dataclass
class HostSampledBatch:
    """Host block stack; `.payload(features, labels)` gathers its inputs."""

    blocks: List[HostBlock]
    num_seeds: int

    def num_valid_edges(self) -> int:
        return sum(b.num_valid_edges() for b in self.blocks)

    def payload(self, features: np.ndarray, labels: np.ndarray):
        """Gather input features (bottom src set) + seed labels, padded."""
        from .native import gather_rows

        b0, btop = self.blocks[0], self.blocks[-1]
        x0 = gather_rows(features, b0.srcs, valid=b0.src_valid)
        y = labels[np.maximum(btop.seeds, 0)].astype(np.int32)
        return x0, y, btop.dst_valid.copy()
