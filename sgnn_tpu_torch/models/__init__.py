from .gnn import GNNParams, MODEL_FAMILIES, init_model, params_from_numpy

__all__ = ["GNNParams", "MODEL_FAMILIES", "init_model", "params_from_numpy"]
