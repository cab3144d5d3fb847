"""Hot-vertex caches (the port of sgnn_tpu/cache/): hotness presampling,
the embedding cache with bounded-staleness weights, and the partial
device feature cache.  The cached trainers are `cache/orchestrator.py`
(host sampler) and `train/device_cached.py` (device sampler)."""

from .embedding_cache import EmbeddingCache, StalenessQueue
from .feature_cache import FeatureCache
from .hotness import presample_hotness, super_batch_stable_shuffle

__all__ = [
    "presample_hotness",
    "super_batch_stable_shuffle",
    "FeatureCache",
    "EmbeddingCache",
    "StalenessQueue",
]
