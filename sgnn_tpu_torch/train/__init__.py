from .engines import (
    ENGINES, EngineSpec, FullBatchEngine, build_trainer, engine_from_config,
    run_engine,
)
from .fullbatch import FullBatchTrainer, build_coo, full_forward
from .inference import InferenceServer, exact_accuracy, layerwise_inference
from .trainer import SampleTrainer, TrainReport

__all__ = [
    "ENGINES",
    "EngineSpec",
    "FullBatchEngine",
    "build_trainer",
    "engine_from_config",
    "run_engine",
    "SampleTrainer",
    "TrainReport",
    "FullBatchTrainer",
    "build_coo",
    "full_forward",
    "InferenceServer",
    "exact_accuracy",
    "layerwise_inference",
]
