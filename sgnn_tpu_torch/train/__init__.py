from .fullbatch import build_coo, full_forward
from .inference import InferenceServer, exact_accuracy, layerwise_inference

__all__ = [
    "build_coo",
    "full_forward",
    "InferenceServer",
    "exact_accuracy",
    "layerwise_inference",
]
