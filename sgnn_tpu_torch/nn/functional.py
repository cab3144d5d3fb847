"""NN math with reference-parity semantics (relu/dropout/log_softmax/nll).

The port's copy of sgnn_tpu/nn/functional.py.  Reference engines use
torch::relu, torch::dropout, log_softmax + nll_loss (e.g.
toolkits/GCN_SAMPLE_PD_CACHE.hpp vertexForward/Loss).  Padded rows of the
dense blocks are excluded from loss and accuracy by the validity masks.
"""

from __future__ import annotations

import torch

# Batch-norm epsilon shared by every BN site, equal to the JAX package's,
# so train/serve parity cannot drift between the two.
BN_EPS = 1e-5


def dropout(generator: torch.Generator, x: torch.Tensor, rate: float,
            train: bool) -> torch.Tensor:
    """Inverted dropout, torch::dropout parity (scale by 1/(1-rate)).  The
    mask is drawn from `generator`, which lives on x's device; it draws
    other bits than the JAX package's key from the same seed."""
    if not train or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < (
        1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def log_softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=dim)


def nll_loss_masked(log_probs: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """Mean NLL over valid rows (torch::nll_loss 'mean' reduction parity):
    padded seed rows contribute nothing and the mean divides by the VALID
    count."""
    picked = log_probs.gather(1, labels[:, None].long())[:, 0]
    per_row = torch.where(valid, -picked, torch.zeros((), dtype=picked.dtype,
                                                      device=picked.device))
    n = valid.sum().clamp_min(1)
    return per_row.sum() / n.to(log_probs.dtype)


def masked_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(correct_count, valid_count) as an int64 [2] tensor, for accuracy
    aggregated across batches (reference getCorrect,
    GCN_SAMPLE_PD_CACHE.hpp:264-295)."""
    pred = logits.argmax(dim=-1)
    correct = ((pred == labels.long()) & valid).sum()
    return torch.stack([correct, valid.sum()])
