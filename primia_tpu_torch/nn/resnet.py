"""ResNet-18 with the reference's MPC-compatibility quirks, as an
``nn.Module``.

Port of ``primia_tpu/nn/resnet.py``, in train and eval mode (``Norm``
picks batch or running statistics by ``module.training``): configurable stem
pooling (max or avg, 3x3/s2/p1), the optional pool<->relu swap of the
stem, batch or group norm, and the fixed ``AvgPool(input_size // 32)``
head in place of adaptive pooling. Attribute names follow the JAX
parameter tree (``conv1``, ``bn1``, ``layerK[i].down_conv``, ``fc``), so
``nn/jax_params.py`` maps a JAX checkpoint onto the state dict by name.
The JAX package's space-to-depth stem (``train/steps.py:79-81``) is an
exact training-time TPU layout rewrite and is not ported.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch.nn.core import Conv, Norm, avg_pool


class BasicBlock(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, norm: str):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1)
        self.bn1 = Norm(planes, norm)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.bn2 = Norm(planes, norm)
        if stride != 1 or cin != planes:
            self.down_conv = Conv(cin, planes, 1, stride, 0)
            self.down_bn = Norm(planes, norm)
        else:
            self.down_conv = self.down_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.down_conv is None else self.down_bn(self.down_conv(x))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """``forward(x)`` takes NCHW float images and returns the logits."""

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2), num_classes: int = 3,
                 in_channels: int = 3, pooling: str = "max", input_size: int = 224,
                 norm: str = "batch", swap_pool_relu: bool = False,
                 zero_init_fc: bool = False):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.in_channels, self.num_classes = in_channels, num_classes
        self.pooling = pooling
        self.input_size = input_size
        self.swap_pool_relu = swap_pool_relu
        self.conv1 = Conv(in_channels, 64, 7, 2, 3)
        self.bn1 = Norm(64, norm)
        cin = 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512), layers)):
            stride = 1 if li == 0 else 2
            blist = []
            for bi in range(blocks):
                blist.append(BasicBlock(cin, planes, stride if bi == 0 else 1, norm))
                cin = planes
            setattr(self, f"layer{li + 1}", nn.ModuleList(blist))
        self.num_layers = len(layers)
        self.fc = nn.Linear(512, num_classes)
        # torch.nn.Linear's default init, as the JAX package's torch_linear_init
        bound = 1.0 / math.sqrt(512)
        nn.init.uniform_(self.fc.weight, -bound, bound)
        nn.init.uniform_(self.fc.bias, -bound, bound)
        if zero_init_fc:
            nn.init.zeros_(self.fc.weight)
            nn.init.zeros_(self.fc.bias)

    def _stem_pool(self, x: torch.Tensor) -> torch.Tensor:
        if self.pooling == "max":
            return F.max_pool2d(x, 3, 2, 1)
        return avg_pool(x, 3, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x))
        if self.swap_pool_relu:
            # pool before relu: identical for max pooling (they commute)
            out = F.relu(self._stem_pool(out))
        else:
            out = self._stem_pool(F.relu(out))
        for li in range(self.num_layers):
            for block in getattr(self, f"layer{li + 1}"):
                out = block(out)
        win = self.input_size // 32
        out = avg_pool(out, win, win, 0)
        return self.fc(torch.flatten(out, 1))


def resnet18(**kw) -> ResNet:
    return ResNet((2, 2, 2, 2), **kw)
