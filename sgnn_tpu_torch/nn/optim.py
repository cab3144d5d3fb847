"""Hand-rolled Adam and SGD with the reference's exact update rules.

The port's copy of sgnn_tpu/nn/optim.py.  Reference: Parameter's
optimizers (core/NtsScheduler.hpp):
  - `learn_local_with_decay_Adam` (:937, the GPU engines' update):
        g   = grad + weight_decay·W
        M   = β1·M + (1-β1)·g
        V   = β2·V + (1-β2)·g²
        W  -= α · M / (√V + ε)          # NO bias correction
  - `learnC2C_with_decay_Adam` (:863, the CPU engines' update): same but
    with bias correction M̂ = M/(1-β1ᵗ), V̂ = V/(1-β2ᵗ).
α = LEARN_RATE, β1 = 0.9, β2 = 0.999, ε = ADAM_EPSILON (1e-9, the
reference's, by default); weight decay is L2-style
(added to the gradient), and the learning rate decays as
α·decay_rate^(step // decay_epoch).  `torch.optim.Adam` has another rule
(ε outside a bias-corrected √V̂, decay not folded the same way), so it is
not used.

`update(grads, state, params)` returns new parameters and state, like the
JAX package's pure functions, computing under `torch.no_grad()` in f32;
it works on any sequence of tensors (the trainers pass
`GNNParams.leaves()`).
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class AdamState(NamedTuple):
    m: Tuple[torch.Tensor, ...]   # first moments, one per parameter
    v: Tuple[torch.Tensor, ...]   # second moments
    step: int                     # updates taken (bias correction, decay)


@dataclasses.dataclass(frozen=True)
class ReferenceAdam:
    learn_rate: float
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-9
    bias_correction: bool = False  # False = GPU-engine rule (flagship)
    decay_rate: float = 1.0        # LR decay: α·decay_rate^(step//decay_epoch)
    decay_epoch: int = 0

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        zeros = tuple(torch.zeros_like(p, dtype=torch.float32) for p in params)
        return AdamState(m=zeros,
                         v=tuple(torch.zeros_like(z) for z in zeros), step=0)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: AdamState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], AdamState]:
        step = state.step + 1
        lr = _f32(self.learn_rate)   # in f32, as the JAX package computes it
        if self.decay_epoch > 0 and self.decay_rate != 1.0:
            lr = lr * _f32(self.decay_rate) ** float(step // self.decay_epoch)
        lr = float(lr)
        new_p, new_m, new_v = [], [], []
        for p, g, m, v in zip(params, grads, state.m, state.v):
            p32 = p.float()
            g = g.float() + self.weight_decay * p32
            m = self.beta1 * m + (1.0 - self.beta1) * g
            v = self.beta2 * v + (1.0 - self.beta2) * g.square()
            if self.bias_correction:
                # β^t in f32, as the JAX package computes it: 1 - β2 in
                # f64 would differ from f32's 1 - 0.999f by 1.3e-5
                m_hat = m / float(1.0 - _f32(self.beta1) ** step)
                v_hat = v / float(1.0 - _f32(self.beta2) ** step)
            else:
                m_hat, v_hat = m, v
            new_p.append((p32 - lr * m_hat / (v_hat.sqrt() + self.epsilon))
                         .to(p.dtype))
            new_m.append(m)
            new_v.append(v)
        return new_p, AdamState(m=tuple(new_m), v=tuple(new_v), step=step)


class SGDState(NamedTuple):
    step: int   # kept for interface symmetry with AdamState


@dataclasses.dataclass(frozen=True)
class ReferenceSGD:
    """SGD with the reference's multiplicative decay,
    Parameter::learnC2C_with_decay_SGD (core/NtsScheduler.hpp:893-898):
        W = (W - lr·grad) · (1 - weight_decay)
    — decay applied AFTER the step, not folded into the gradient."""

    learn_rate: float
    weight_decay: float = 1e-4

    def init(self, params: Sequence[torch.Tensor]) -> SGDState:
        return SGDState(step=0)

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], state: SGDState,
               params: Sequence[torch.Tensor]
               ) -> Tuple[List[torch.Tensor], SGDState]:
        decay = 1.0 - self.weight_decay
        new_p = [((p.float() - self.learn_rate * g.float()) * decay)
                 .to(p.dtype) for p, g in zip(params, grads)]
        return new_p, SGDState(step=state.step + 1)


def make_optimizer(cfg, bias_correction: bool = False):
    """Optimizer from cfg.optimizer ("adam" | "sgd"), reference defaults."""
    if getattr(cfg, "optimizer", "adam").lower() == "sgd":
        return ReferenceSGD(learn_rate=cfg.learn_rate,
                            weight_decay=cfg.weight_decay)
    return ReferenceAdam(
        learn_rate=cfg.learn_rate,
        weight_decay=cfg.weight_decay,
        epsilon=cfg.adam_epsilon,
        bias_correction=bias_correction,
        decay_rate=cfg.decay_rate,
        decay_epoch=cfg.decay_epoch,
    )
