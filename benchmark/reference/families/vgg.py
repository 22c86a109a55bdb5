"""VGG-16 configuration D (Simonyan and Zisserman 2014) with PriMIA's
average-pool head and 512-512-classes classifier: its plain forward and
its MACs."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.counts import conv_macs
from benchmark.reference.models import conv, linear, pool


def forward(W: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor], x: torch.Tensor,
            arch: dict, train: bool, precision: str, taps: dict, settle: bool) -> torch.Tensor:
    i = 0
    for c in arch["features"]:
        if c == "M":
            x = pool(x, arch["pooling"], 2, 2)
        else:
            y = conv(x, W[f"features.{i}.weight"], 1, 1, precision)
            x = F.relu(y + W[f"features.{i}.bias"].reshape(1, -1, 1, 1))
            i += 1
    win = arch["resolution"] // 32
    x = torch.flatten(F.avg_pool2d(x, win, win), 1)
    n = len(arch["classifier"])
    for j in range(n):
        if j == n - 1:
            taps["head_input"] = x
        x = linear(x, W[f"classifier.{j}.weight"], W[f"classifier.{j}.bias"], precision)
        if j < n - 1:
            x = F.relu(x)
    return x


def macs(arch: dict, num_classes: int) -> Tuple[int, int]:
    h, c, total = arch["resolution"], arch["in_channels"], 0
    for v in arch["features"]:
        if v == "M":
            h //= 2
        else:
            total += conv_macs(c, v, 3, h, h)
            c = v
    lin, width = 0, c
    for out in list(arch["classifier"][:-1]) + [num_classes]:
        lin += width * out
        width = out
    return total, lin
