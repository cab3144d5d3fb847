from .blocks import SampledBatch, SampledBlock, WeightKind, pad_to

__all__ = ["SampledBatch", "SampledBlock", "WeightKind", "pad_to"]
