from .functional import BN_EPS, dropout, log_softmax, masked_accuracy, nll_loss_masked
from .layers import Dense, xavier_uniform_init
from .optim import ReferenceAdam, ReferenceSGD, make_optimizer

__all__ = ["BN_EPS", "Dense", "dropout", "log_softmax", "masked_accuracy",
           "nll_loss_masked", "xavier_uniform_init", "ReferenceAdam",
           "ReferenceSGD", "make_optimizer"]
