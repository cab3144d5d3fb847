"""Partial device feature cache for graphs whose features exceed device memory.

The port of sgnn_tpu/cache/feature_cache.py.  Reference: the GPU feature
cache — the highest-degree `feature_cache_rate` fraction of the vertices'
raw features staged in GPU memory
(gater_cpu_cache_feature_and_trans_to_gpu, GCN_SAMPLE_PD_CACHE.hpp:1079;
capacity probed from free memory, determine_cache_node_idx :1039), the
feature loader consulting the cache map before reading the host
(load_feature_gpu_cache, ntsFastSampler.hpp:263).

When the whole matrix fits, the trainer keeps it resident and this cache is
unused.  Otherwise the hot rows live on the device ([C, F] plus a slot
map); a batch ships only its COLD rows, compacted (`gather_cold_compact`),
and its x0 is assembled on the device: the cold rows scattered onto the
source axis (`scatter_cold_rows`), then the hot rows overlaid
(`merge_device`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..utils.profiling import CPU_BUDGET_BYTES, device_memory_stats


@dataclasses.dataclass
class FeatureCache:
    hot_ids: np.ndarray                    # [C] global ids cached
    slot_map: np.ndarray                   # [V] int32 slot or -1 (host)
    device: torch.device
    dev_slot_map: Optional[torch.Tensor] = None   # [V] int32 (after upload)
    dev_hot: Optional[torch.Tensor] = None        # [C, F] (after upload)
    hits: int = 0
    misses: int = 0
    bytes_shipped: int = 0   # cold-row bytes actually sent to the device
    bytes_full: int = 0      # what shipping every source row would send

    @staticmethod
    def build(features: np.ndarray, hot_ids: np.ndarray,
              dtype: Optional[torch.dtype] = None, upload: bool = True,
              device=None) -> "FeatureCache":
        """`upload=False` defers staging the rows (`upload()`): per-SB
        plans keep only the ACTIVE super-batch's [C, F] rows resident."""
        slot_map = np.full(features.shape[0], -1, dtype=np.int32)
        slot_map[hot_ids] = np.arange(hot_ids.size, dtype=np.int32)
        fc = FeatureCache(hot_ids=np.asarray(hot_ids, np.int32),
                          slot_map=slot_map, device=resolve_device(device))
        if upload:
            fc.upload(features, dtype)
        return fc

    def upload(self, features: np.ndarray,
               dtype: Optional[torch.dtype] = None) -> None:
        """Stage this plan's hot rows (and slot map) on the device as
        `dtype` (None keeps the store's), releasing the previous rows
        first (reference new_cache_var/set_cache_index swap,
        ntsDataloador.hpp:285/:440)."""
        from ..sampler.native import gather_rows

        self.dev_hot = None
        rows = (gather_rows(features, self.hot_ids) if self.hot_ids.size
                else np.zeros((0, features.shape[1]), features.dtype))
        self.dev_slot_map = torch.from_numpy(self.slot_map).to(self.device)
        self.dev_hot = torch.from_numpy(rows).to(self.device, dtype)

    # ------------------------------------------------------------------
    def merge_device(self, x0_cold: torch.Tensor, srcs: torch.Tensor,
                     src_valid: torch.Tensor) -> torch.Tensor:
        """Device side: overlay the cached hot rows onto x0 (valid sources
        with a slot take their cached row)."""
        if self.dev_hot.shape[0] == 0:
            return x0_cold
        slots = self.dev_slot_map[srcs.long()]
        hot = self.dev_hot.index_select(0, slots.clamp_min(0).long())
        use_hot = (slots >= 0) & src_valid
        return torch.where(use_hot[:, None], hot, x0_cold)

    def gather_host_cold(self, features: np.ndarray, srcs: np.ndarray,
                         src_valid: np.ndarray) -> Tuple[np.ndarray,
                                                         np.ndarray]:
        """Host side, uncompacted: (x0_cold [S, F], is_cold [S] bool), the
        cold rows gathered and the cached ones zeros (`merge_device` then
        overlays them); hits and misses counted as the reference's
        total_sample_num / total_cache_hit (cuda/ntsCUDA.hpp:182)."""
        slots = self.slot_map[np.maximum(srcs, 0)]
        cold = (slots < 0) & src_valid
        x0 = np.zeros((srcs.shape[0], features.shape[1]), features.dtype)
        x0[cold] = features[srcs[cold]]
        ncold = int(cold.sum())
        self.misses += ncold
        self.hits += int(src_valid.sum()) - ncold
        return x0, cold

    @property
    def hit_rate(self) -> float:
        """Hits over lookups so far (0 before any)."""
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    # ----------------------------------------------- compacted cold path
    def gather_cold_compact(self, features: np.ndarray, srcs: np.ndarray,
                            src_valid: np.ndarray) -> Tuple[np.ndarray,
                                                            np.ndarray]:
        """The cache-miss rows in a COMPACT bucketed buffer: (x0_cold [P,
        F], cold_pos [P] int32), P the smallest power-of-two multiple of
        128 >= the miss count (`_cold_bucket`), so host-to-device feature
        traffic shrinks by the hit rate.  Padding entries of cold_pos point
        one past the source axis (S); `scatter_cold_rows` writes them to a
        row it then drops."""
        from ..sampler.native import gather_rows

        slots = self.slot_map[np.maximum(srcs, 0)]
        cold = (slots < 0) & src_valid
        pos = np.nonzero(cold)[0].astype(np.int32)
        self.misses += pos.size
        self.hits += int(src_valid.sum()) - pos.size
        pad = _cold_bucket(pos.size, srcs.shape[0])
        x0 = np.zeros((pad, features.shape[1]), features.dtype)
        if pos.size:
            x0[: pos.size] = gather_rows(features, srcs[pos])
        cold_pos = np.full(pad, srcs.shape[0], np.int32)
        cold_pos[: pos.size] = pos
        self.bytes_shipped += x0.nbytes
        self.bytes_full += (srcs.shape[0] * features.shape[1]
                            * features.itemsize)
        return x0, cold_pos


def check_cold_pos(cold_pos: np.ndarray, num_src: int) -> None:
    """cold_pos entries lie in [0, num_src] (num_src = padding), checked
    once on the host: a CUDA scatter writes out of bounds where JAX's
    `mode="drop"` drops."""
    if cold_pos.size and (int(cold_pos.min()) < 0
                          or int(cold_pos.max()) > num_src):
        raise ValueError(f"cold_pos outside [0, {num_src}]")


def scatter_cold_rows(x0_cold: torch.Tensor, cold_pos: torch.Tensor,
                      num_src: int) -> torch.Tensor:
    """x0 [num_src, F] with row cold_pos[i] = x0_cold[i] and zeros
    elsewhere: scattered into num_src + 1 rows and the last (where every
    padding entry lands, with its zero row) dropped."""
    x0 = x0_cold.new_zeros((num_src + 1, x0_cold.shape[1]))
    x0.index_copy_(0, cold_pos.long(), x0_cold)
    return x0[:num_src]


def _cold_bucket(n: int, cap: int) -> int:
    """Smallest power-of-two multiple of 128 >= n, within [128, max(cap,
    128)]."""
    b = 128
    while b < n:
        b *= 2
    return min(max(b, 128), max(cap, 128))


def hbm_feature_capacity(feature_dim: int, itemsize: int,
                         budget_bytes: Optional[int] = None,
                         headroom_fraction: float = 0.5,
                         device=None) -> int:
    """How many feature rows fit in free device memory (reference
    determine_cache_node_idx, GCN_SAMPLE_PD_CACHE.hpp:1039-1077: probe
    idle memory, rows = free / row bytes).  `budget_bytes` (HBM_BUDGET)
    when given; else `headroom_fraction` of the card's free memory
    (`utils.profiling.device_memory_stats`); with no statistics (the CPU)
    the JAX package's generous 1 GiB."""
    if budget_bytes is None:
        budget_bytes = feature_budget_bytes(device, headroom_fraction)
    return max(int(budget_bytes) // max(feature_dim * itemsize, 1), 0)


def feature_budget_bytes(device=None, headroom_fraction: float = 0.5) -> int:
    """The capacity probe's budget without HBM_BUDGET: `headroom_fraction`
    of the card's free memory (`utils.profiling.device_memory_stats`), or
    the JAX package's 1 GiB where there are no statistics (the CPU)."""
    stats = device_memory_stats(resolve_device(device))
    if stats and stats.get("bytes_limit"):
        free = stats["bytes_limit"] - stats.get("bytes_in_use", 0)
        return int(free * headroom_fraction)
    return CPU_BUDGET_BYTES


def degree_ranked_hot_ids(adj, max_rows: int) -> np.ndarray:
    """The `max_rows` highest-out-degree vertices, ascending by id
    (reference cache_high_degree, GCN_SAMPLE_PD_CACHE.hpp:1026-1037)."""
    max_rows = int(min(max_rows, adj.num_vertices))
    if max_rows <= 0:
        return np.zeros(0, np.int32)
    order = np.argsort(-adj.out_degree.astype(np.int64), kind="stable")
    return np.sort(order[:max_rows].astype(np.int32))
