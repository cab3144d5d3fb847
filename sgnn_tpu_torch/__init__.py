"""sgnn_tpu_torch — the PyTorch/CUDA port of sgnn_tpu, for one NVIDIA H100.

The port imports torch and numpy and nothing of JAX or of `sgnn_tpu`; only
the tests import both packages, to hold one against the other on the same
numpy inputs.  Its kernels are CUDA C++ under `csrc/`, built with nvcc at
first use (`ops/cuda/build.py`); each has a plain PyTorch version beside it.

Device rule: every entry point takes `device=None`, which means CUDA.
Without a card that raises; the plain PyTorch versions run only when the
caller asks for the CPU (`device="cpu"`), as the CPU tests do.  Precision
rule: f32 products in full f32 on the card (`full_f32_products`).
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The one place that picks a device: None means CUDA, with no fallback.

    Raises RuntimeError for a CUDA device when no card is visible, and
    ValueError for a device type the port does not run on."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sgnn_tpu_torch: no CUDA device is visible; pass "
                "device='cpu' to run the plain PyTorch versions")
    elif dev.type != "cpu":
        raise ValueError(f"sgnn_tpu_torch runs on cuda or cpu, not {dev}")
    return dev


def full_f32_products(device: torch.device) -> None:
    """The precision choice of the whole package: f32 products in full f32
    on the card, as the JAX package computes them (TF32 keeps ~3 decimal
    digits; serving is held to the CPU pass at 1e-4).  Process-wide, like
    every torch.backends flag; the trainers and serving call it."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
