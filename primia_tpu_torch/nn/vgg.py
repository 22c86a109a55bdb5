"""VGG-16 (configuration D, no batch norm) as an ``nn.Module``.

Port of ``primia_tpu/nn/vgg.py`` (reference ``torchlib/models.py:88-216``):
thirteen 3x3/s1/p1 convs with biases, each followed by a ReLU, 2x2/s2
pools (max or avg) after the blocks of ``VGG16_CFG``, the fixed
``AvgPool(input_size // 32)`` head and the 512-512-classes classifier
(weights N(0, 0.01), biases zero). ``features`` holds the 13 convs only,
with the pools outside it, so ``features.i`` is the JAX package's
``params["features"][i]`` and ``classifier.i`` its ``params["classifier"][i]``
(``nn/jax_params.py``).

No dropout: the JAX train step never passes ``rng`` to the forward
(``primia_tpu/train/steps.py:96-97``), so its ``E.dropout`` returns its
input, and the port trains the same function.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch.nn.core import Conv, avg_pool, mlp_head, pool2x2

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class VGG(nn.Module):
    """``forward(x)`` takes NCHW float images and returns the logits."""

    cfg = VGG16_CFG

    def __init__(self, num_classes: int = 3, in_channels: int = 3, pooling: str = "max",
                 input_size: int = 224):
        super().__init__()
        if pooling not in ("max", "avg"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.in_channels, self.num_classes = in_channels, num_classes
        self.pooling, self.input_size = pooling, input_size
        convs, cin = [], in_channels
        for c in self.cfg:
            if c != "M":
                convs.append(Conv(cin, c, 3, 1, 1, bias=True))
                cin = c
        self.features = nn.ModuleList(convs)
        self.classifier = nn.ModuleList(
            [nn.Linear(512, 512), nn.Linear(512, 512), nn.Linear(512, num_classes)])
        for lin in self.classifier:
            nn.init.normal_(lin.weight, std=0.01)
            nn.init.zeros_(lin.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        convs = iter(self.features)
        for c in self.cfg:
            x = pool2x2(x, self.pooling) if c == "M" else F.relu(next(convs)(x))
        win = self.input_size // 32
        return mlp_head(self.classifier, avg_pool(x, win, win))


def vgg16(**kw) -> VGG:
    return VGG(**kw)
