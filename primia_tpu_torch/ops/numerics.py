"""Numeric rules that the kernels' plain versions share."""

from __future__ import annotations

import torch


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as IEEE division on every device. On CUDA, PyTorch
    divides a tensor by a Python number as a product with the number's
    reciprocal, which can differ in the last bit (and then flip a
    rounding); a one-element divisor on ``x``'s device keeps the true
    quotient, as the kernels and the JAX reference compute it. The
    divisor is filled on the device: ``torch.tensor`` would copy it from
    the host and wait for the stream."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)
