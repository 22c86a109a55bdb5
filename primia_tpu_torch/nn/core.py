"""Plain NN ops on NCHW tensors, and the modules that hold their weights.

Port of the plain engine of ``primia_tpu/nn/core.py``. The JAX package
is NHWC with HWIO conv weights and (in, out) linear weights; here
activations are NCHW (``channels_last`` in memory on the card), conv
weights OIHW and linear weights (out, in) — ``nn/jax_params.py`` maps one
layout onto the other. Convolutions go to ``F.conv2d`` (cuDNN on the
card), as the JAX package left them to XLA.

Only inference-mode normalisation is ported so far: batch norm from its
running statistics, and group norm (which has no running statistics).
Train-mode batch norm comes with the training slice (ROADMAP).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def bn_fold(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Inference batch norm as a channelwise affine ``x * scale + offset``,
    with the channel math in float32 (``primia_tpu/nn/core.py:bn_fold`` and
    the eval branch of ``batch_norm``)."""
    inv = gamma.float() * torch.rsqrt(var.float() + eps)
    return {"scale": inv, "offset": beta.float() - mean.float() * inv}


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm from running statistics: the float32 affine of
    :func:`bn_fold`, cast to the activation dtype."""
    f = bn_fold(gamma, beta, mean, var, eps)
    return x * _channel(f["scale"]).to(x.dtype) + _channel(f["offset"]).to(x.dtype)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with ``torch.nn.GroupNorm`` semantics: per-example
    statistics over (C/G, H, W) of each of ``min(groups, C)`` groups of
    neighbouring channels, statistics in float32, then the channelwise
    affine."""
    B, C = x.shape[:2]
    G = min(groups, C)
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    xf = x.float().reshape(B, G, -1)
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp(min=0.0)
    xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
    return xhat * _channel(gamma) + _channel(beta)


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Average pool dividing by ``window**2`` everywhere
    (``count_include_pad=True``, as the reference model's AvgPool2d)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


class Conv(nn.Module):
    """Bias-free NCHW conv with OIHW weights and symmetric padding;
    He-normal (fan_out, relu gain) init as the JAX package's
    ``kaiming_normal_conv``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        nn.init.normal_(self.weight, std=math.sqrt(2.0 / (k * k * cout)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)


class Norm(nn.Module):
    """Batch norm (``kind="batch"``, eval mode) or group norm
    (``kind="group"``). Both keep the same weights and BN-shaped buffers,
    so checkpoints are layout-identical, as in the JAX package."""

    def __init__(self, c: int, kind: str = "batch", eps: float = 1e-5):
        super().__init__()
        if kind not in ("batch", "group"):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.eps = kind, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "group":
            return group_norm(x, self.weight, self.bias, eps=self.eps)
        if self.training:
            raise NotImplementedError(
                "train-mode batch norm is not ported yet (ROADMAP, training slice); "
                "call .eval() on the model")
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.eps)
