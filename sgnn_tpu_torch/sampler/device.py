"""On-device fanout sampling with plain torch ops (static shapes, no host
round trip).

The port of sgnn_tpu/sampler/device.py.  Reference analog: the GPU sampler
(`sample_gpu_fast`, core/ntsFastSampler.hpp:648 → warp-traverse kernels
cuda/ntsCUDATransferKernel.cuh:852-1105).  Per hop: uniform position draws
from a `torch.Generator` on the batch's device, clamped to deg-1; an O(K²)
in-row duplicate mask; the source set as a presence bitmap over [V]
(`index_fill_`; each slot not kept and each padded seed writes a private
dump entry past V, so writes share an address only where they are the same
vertex), ranked by `cumsum`, and the present ids read back from the ranks
by a sorted search; edges whose source rank overflows an estimated bound
are dropped and counted.  A bottom hop whose bound is the whole (padded)
vertex set takes the identity branch: local ids are global ids and x0 is
the feature matrix itself.  Duplicates within a row are masked rather than
redrawn, as in the JAX package.  The draws are torch's, not jax.random's:
the tests hold this sampler to invariants, not to the JAX package's
draws.

By construction every kept slot's local index is below the hop's
`num_src_pad` (`keep_fit`), so K1's gathers stay in bounds.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..utils import timing
from .blocks import SampledBatch, SampledBlock, WeightKind


def _edge_weights(keep, nbr_local, num_src_pad, fanout, weight_kind,
                  degree_mode, nbr_global, seeds, in_degree, out_degree):
    """Edge weights (get_weight/get_mean_weight kernels,
    cuda/ntsCUDATransferKernel.cuh:293-343): "global" degrees from the
    full-graph tables, "sampled" degrees recomputed inside the batch."""
    zero = torch.zeros((), dtype=torch.float32, device=keep.device)
    if weight_kind == WeightKind.NONE:
        return keep.float()
    if degree_mode == "global":
        if weight_kind == WeightKind.MEAN:
            # plain mean aggregator (1/sampled-count), the JAX package's
            # deliberate deviation from the reference's global-degree hybrids
            cnt = keep.sum(dim=1).clamp_min(1).float()
            return torch.where(keep, 1.0 / cnt[:, None], zero)
        od = out_degree[nbr_global.clamp_min(0).long()].clamp_min(1)
        idg = in_degree[seeds.long()].clamp_min(1)
        w = 1.0 / (od.float().sqrt() * idg.float().sqrt()[:, None])
        return torch.where(keep, w, zero)
    samp_in = keep.sum(dim=1).to(torch.int32)
    samp_in = torch.where(samp_in == 0, fanout, samp_in)
    counts = torch.zeros(num_src_pad, dtype=torch.int32, device=keep.device)
    counts.index_add_(0, nbr_local.reshape(-1).long(),
                      keep.reshape(-1).to(torch.int32))
    out_deg = counts[nbr_local.long()].clamp_min(1)
    w = 1.0 / (out_deg.float().sqrt() * samp_in.float().sqrt()[:, None])
    if weight_kind == WeightKind.MEAN:
        w = w / keep.sum(dim=1).clamp_min(1)[:, None].float()
    return torch.where(keep, w, zero)


def _source_set(keep, nbr_global, seeds_l, dst_valid, num_vertices,
                num_src_pad):
    """A hop's source set (reference bitmap + src_index_array reindex,
    ntsFastSampler.hpp:1062-1080) → (srcs, src_valid, lookup).

    The kept slots' sources and the valid seeds mark a presence bitmap over
    [V]; every slot not kept and every invalid seed marks its own dump
    entry past V instead.  `lookup` ([V]) is each present id's rank less
    one, by prefix sum.  The ids present are increasing and so are their
    ranks, so slot i of `srcs` is the first vertex of rank i + 1: a sorted
    search of the prefix sum, no scatter.  Past `num_src_pad` present ids
    the rank space overflows; slots past the present ids hold 0."""
    dev = keep.device
    b, fanout = keep.shape
    n_slots = b * fanout
    presence = torch.zeros(num_vertices + n_slots + b, dtype=torch.int32,
                           device=dev)
    dump = torch.arange(num_vertices, num_vertices + n_slots + b, device=dev)
    presence.index_fill_(0, torch.where(
        keep, nbr_global, dump[:n_slots].view(b, fanout)).reshape(-1), 1)
    presence.index_fill_(0, torch.where(dst_valid, seeds_l, dump[n_slots:]),
                         1)
    ranks = presence[:num_vertices].cumsum(0)
    rank_of_slot = torch.arange(1, num_src_pad + 1, device=dev)
    src_valid = rank_of_slot <= ranks[-1]
    srcs = torch.where(src_valid, torch.searchsorted(ranks, rank_of_slot,
                                                     out_int32=True), 0)
    return srcs, src_valid, ranks - 1


def _sample_hop(generator, seeds, dst_valid, indptr, indices, fanout,
                num_src_pad, weight_kind, in_degree, out_degree,
                identity_srcs=False, degree_mode="sampled", omit_map=None
                ) -> Tuple[SampledBlock, torch.Tensor]:
    """One hop: (block, overflow count).  With `omit_map`, destinations
    holding a cache slot are not expanded (degree 0)."""
    dev = seeds.device
    b = seeds.shape[0]
    seeds_l = seeds.long()
    start = indptr[seeds_l]
    deg = (indptr[seeds_l + 1] - start).to(torch.int32)
    if omit_map is not None:
        # cache-omitting sampling (reference sample_gpu_fast_omit,
        # ntsFastSampler.hpp:711): a cached destination's layer-0 output
        # comes from the hot cache
        deg = torch.where(omit_map[seeds_l] >= 0, 0, deg)
    # uniform position draw (with replacement) over each row's degree; the
    # f32 product can round up to exactly deg for large degrees, so clamp
    u = torch.rand((b, fanout), generator=generator, device=dev)
    draw = torch.minimum((u * deg[:, None].float()).to(torch.int32),
                         (deg[:, None] - 1).clamp_min(0))
    slots = torch.arange(fanout, dtype=torch.int32, device=dev)
    pos = torch.where(deg[:, None] <= fanout, slots.expand(b, fanout), draw)
    valid = (slots[None, :] < deg[:, None]) & dst_valid[:, None]
    # slot k is a duplicate iff an earlier slot j < k drew the same position
    eq = pos[:, None, :] == pos[:, :, None]               # [B, K(k), K(j)]
    earlier = slots[None, :] < slots[:, None]              # [k, j]: j < k
    keep = valid & ~(eq & earlier[None]).any(dim=2)
    edge = (start[:, None] + pos).clamp(0, indices.shape[0] - 1)
    nbr_global = torch.where(keep, indices[edge], -1)
    num_vertices = indptr.shape[0] - 1
    if identity_srcs:
        # bottom hop whose source bound is the whole vertex set: the local
        # index space IS the global id space — no dedup, no reindex
        if num_src_pad != num_vertices:
            raise ValueError("the identity hop needs num_src_pad == V")
        nbr = nbr_global.clamp_min(0)
        block = SampledBlock(
            nbr=nbr,
            weight=_edge_weights(keep, nbr, num_src_pad, fanout, weight_kind,
                                 degree_mode, nbr_global, seeds, in_degree,
                                 out_degree),
            srcs=torch.arange(num_src_pad, dtype=torch.int32, device=dev),
            seeds=seeds, dst_valid=dst_valid,
            src_valid=torch.ones(num_src_pad, dtype=torch.bool, device=dev),
            seed_in_src=seeds)
        return block, torch.zeros((), dtype=torch.int32, device=dev)
    timing.RECORDER.counters.add("sampler.rank_hops", 1)
    srcs, src_valid, lookup = _source_set(keep, nbr_global, seeds_l,
                                          dst_valid, num_vertices,
                                          num_src_pad)
    # with an estimated bound (SRC_PAD_FACTOR) the tail of the rank space
    # can overflow: every edge pointing past it is dropped (weight 0) and
    # counted
    nbr_rank = lookup[nbr_global.clamp_min(0).long()]
    keep_fit = keep & (nbr_rank < num_src_pad)
    nbr_local = torch.where(keep_fit, nbr_rank, 0).to(torch.int32)
    # a seed whose own rank overflows is marked invalid, never clipped
    seed_rank = lookup[seeds_l]
    seed_ok = dst_valid & (seed_rank < num_src_pad)
    seed_in_src = torch.where(seed_ok, seed_rank.clamp_min(0), 0).to(
        torch.int32)
    n_overflow = ((keep & ~keep_fit).sum()
                  + (dst_valid & ~seed_ok).sum()).to(torch.int32)
    w = _edge_weights(keep_fit, nbr_local, num_src_pad, fanout, weight_kind,
                      degree_mode, nbr_global, seeds, in_degree, out_degree)
    return SampledBlock(nbr=nbr_local, weight=w, srcs=srcs, seeds=seeds,
                        dst_valid=seed_ok, src_valid=src_valid,
                        seed_in_src=seed_in_src), n_overflow


def device_sample_batch(
    generator: torch.Generator,
    seeds: torch.Tensor,
    seed_valid: torch.Tensor,
    indptr: torch.Tensor,
    indices: torch.Tensor,
    in_degree: torch.Tensor,
    out_degree: torch.Tensor,
    features: torch.Tensor,
    labels: torch.Tensor,
    fanouts: Tuple[int, ...],
    src_pads: Tuple[int, ...],
    weight_kind: WeightKind = WeightKind.GCN,
    degree_mode: str = "sampled",
    feat_scale: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.float32,
    omit_map: Optional[torch.Tensor] = None,
    gather_features: bool = True,
) -> SampledBatch:
    """Sample an L-hop batch on the seeds' device and gather its payload.

    `indptr` (int64 [V+1]) and `indices` (int32 [E_pad]) are the padded
    whole-graph CSC; `src_pads[h]` is the static source-set bound of hop h
    (seed hop first).  Returns blocks in input→output order, x0 gathered
    from `features` (or `features` itself on the identity bottom hop), and
    the overflow count.  `feat_scale` ([F] per-column scales) marks
    `features` as int8 storage (FEATURE_DTYPE:int8, data/quant.py): the
    gathered rows are dequantized to `compute_dtype`, and the identity
    bottom hop is off (it would hand over the whole quantized matrix).
    `omit_map` (int32 [V_pad], slot or -1) turns on cache-omitting
    sampling at the bottom hop; the batch then carries `cache_mask` and
    `cache_slot` for the model's layer-0 merge.  `gather_features=False`
    leaves x0 to the caller (row-sharded features: the data-parallel
    wrapper fetches the rows from their owner ranks, parallel/
    sharded_features.py); x0 is then a [1, 1] placeholder.  The
    identity bottom hop stays on there (the JAX package turns it off): the
    caller then fetches every row in id order, the x0 the replicated
    features would give, so both layouts compute the same products."""
    blocks: List[SampledBlock] = []
    cur_seeds, cur_valid = seeds, seed_valid
    num_vertices = indptr.shape[0] - 1
    identity = False
    overflow = torch.zeros((), dtype=torch.int32, device=seeds.device)
    for h, f in enumerate(fanouts):
        last = h == len(fanouts) - 1
        identity = (last and src_pads[h] == num_vertices
                    and feat_scale is None
                    and (not gather_features
                         or features.shape[0] == num_vertices))
        blk, n_over = _sample_hop(
            generator, cur_seeds, cur_valid, indptr, indices, f, src_pads[h],
            weight_kind, in_degree, out_degree, identity_srcs=identity,
            degree_mode=degree_mode, omit_map=omit_map if last else None)
        blocks.append(blk)
        cur_seeds, cur_valid = blk.srcs, blk.src_valid
        overflow = overflow + n_over
    blocks.reverse()
    cache_mask = cache_slot = None
    if omit_map is not None:
        slots = omit_map[blocks[0].seeds.long()]
        cache_mask = (slots >= 0) & blocks[0].dst_valid
        cache_slot = slots.clamp_min(0).to(torch.int32)
    if not gather_features:
        x0 = torch.zeros((1, 1), dtype=compute_dtype, device=seeds.device)
    elif identity:
        x0 = features   # the whole feature matrix IS x0: no re-gather
    else:
        b0 = blocks[0]
        rows = features.index_select(0, b0.srcs.long())
        if feat_scale is not None:
            rows = rows.to(compute_dtype) * feat_scale.to(compute_dtype)
        x0 = torch.where(b0.src_valid[:, None], rows,
                         torch.zeros((), dtype=rows.dtype, device=rows.device))
    top = blocks[-1]
    return SampledBatch(blocks=blocks, x0=x0.to(compute_dtype),
                        labels=labels[top.seeds.long()],
                        label_valid=top.dst_valid, cache_mask=cache_mask,
                        cache_slot=cache_slot, overflow=overflow)
