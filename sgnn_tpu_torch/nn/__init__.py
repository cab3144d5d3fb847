from .functional import BN_EPS, log_softmax
from .layers import xavier_uniform_init

__all__ = ["BN_EPS", "log_softmax", "xavier_uniform_init"]
