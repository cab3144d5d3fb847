"""NN math with reference-parity semantics (log_softmax, batch-norm epsilon).

Dropout, the masked NLL and accuracy join with the training slice.
"""

from __future__ import annotations

import torch

# Batch-norm epsilon shared by every BN site, equal to the JAX package's,
# so train/serve parity cannot drift between the two.
BN_EPS = 1e-5


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=dim)
