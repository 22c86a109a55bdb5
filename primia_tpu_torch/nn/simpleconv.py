"""The three "simpleconv" CNNs at 28, 224 and 512 px, as an ``nn.Module``.

Port of ``primia_tpu/nn/simpleconv.py`` (reference ``torchlib/models.py:
558-719``: ``ConvNetMNIST``, ``ConvNet224``, ``ConvNet512``): six 3x3
valid convs with biases (channels 8, 32, 64, 128, 256, 512), each followed
by a ReLU, 2x2/s2 pools (max or avg) in each resolution's pattern, and the
512-512-classes head with torch's Linear init. The pools floor odd maps
(222 -> 111 at 224 px, 255 -> 127 at 512 px). At 224 px a norm (batch or
group) follows pools 1, 2 and 4; ``bns`` keeps the JAX package's string
keys ``"0"``, ``"1"``, ``"3"``, so ``bns.3`` is ``params["bns"]["3"]``
(``nn/jax_params.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch.nn.core import Conv, Norm, mlp_head, pool2x2

CHANNELS = (8, 32, 64, 128, 256, 512)
RESOLUTIONS = (28, 224, 512)
BN_AFTER = (0, 1, 3)  # at 224 px: a norm after the pools of convs 1, 2 and 4


class SimpleConv(nn.Module):
    """``forward(x)`` takes NCHW float images at ``resolution`` px and
    returns the logits."""

    def __init__(self, resolution: int = 224, num_classes: int = 3, in_channels: int = 1,
                 pooling: str = "max", norm: str = "batch", zero_init_fc: bool = False):
        super().__init__()
        if resolution not in RESOLUTIONS:
            raise ValueError(f"simpleconv supports 28/224/512 px, got {resolution}")
        if pooling not in ("max", "avg"):
            raise ValueError(f"unknown pooling {pooling!r}")
        self.resolution = self.input_size = resolution
        self.in_channels, self.num_classes, self.pooling = in_channels, num_classes, pooling
        cins = (in_channels,) + CHANNELS[:-1]
        self.convs = nn.ModuleList(Conv(ci, co, 3, 1, 0, bias=True)
                                   for ci, co in zip(cins, CHANNELS))
        self.bns = nn.ModuleDict(
            {str(i): Norm(CHANNELS[i], norm) for i in BN_AFTER} if resolution == 224 else {})
        self.classifier = nn.ModuleList(
            [nn.Linear(512, 512), nn.Linear(512, 512), nn.Linear(512, num_classes)])
        for lin in self.classifier:
            # torch.nn.Linear's default init, as the JAX package's torch_linear_init
            bound = 1.0 / math.sqrt(lin.in_features)
            nn.init.uniform_(lin.weight, -bound, bound)
            nn.init.uniform_(lin.bias, -bound, bound)
        if zero_init_fc:
            nn.init.zeros_(self.classifier[-1].weight)
            nn.init.zeros_(self.classifier[-1].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def conv(i, t):
            return F.relu(self.convs[i](t))

        def pool(t):
            return pool2x2(t, self.pooling)

        if self.resolution == 28:
            # ConvNetMNIST: convs 1-4 without a pool between, pools after 4, 5, 6
            for i in range(4):
                x = conv(i, x)
            x = pool(conv(5, pool(conv(4, pool(x)))))
        elif self.resolution == 224:
            for i in range(6):
                x = pool(conv(i, x))
                if str(i) in self.bns:
                    x = self.bns[str(i)](x)
        else:  # 512
            x = pool(pool(conv(0, x)))
            for i in range(1, 6):
                x = pool(conv(i, x))
            x = pool(x)
        return mlp_head(self.classifier, x)


def simpleconv(**kw) -> SimpleConv:
    return SimpleConv(**kw)
