from .blocks import WeightKind, pad_to

__all__ = ["WeightKind", "pad_to"]
