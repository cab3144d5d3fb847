"""Parameter initialisation and the bias-free linear layer.

Reference: Parameter (core/NtsScheduler.hpp:680) holds one weight matrix per
layer, xavier_uniform-initialised (NtsScheduler.hpp:733, gain 1.0), and
its forward is x·W.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def xavier_uniform_init(
    generator: torch.Generator, in_dim: int, out_dim: int, gain: float = 1.0,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """torch::nn::init::xavier_uniform_ parity: U(-a, a), a = gain·√(6/(fi+fo)).

    Drawn on the generator's device (the CPU for a default generator): the
    caller moves the result, so a seed gives the same weights everywhere."""
    a = gain * math.sqrt(6.0 / (in_dim + out_dim))
    out = torch.empty((in_dim, out_dim), dtype=dtype, device=generator.device)
    return out.uniform_(-a, a, generator=generator)


class Dense(NamedTuple):
    """A bias-free linear layer (reference Parameter::forward = x·W): a
    plain value holding its [in, out] weight, as the JAX package's."""

    w: torch.Tensor

    @staticmethod
    def init(generator: torch.Generator, in_dim: int, out_dim: int,
             dtype: torch.dtype = torch.float32) -> "Dense":
        return Dense(w=xavier_uniform_init(generator, in_dim, out_dim,
                                           dtype=dtype))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x·W in x's dtype."""
        return x @ self.w.to(x.dtype)
