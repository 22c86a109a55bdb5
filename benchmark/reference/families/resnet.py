"""ResNet-18 (He et al. 2015) with PriMIA's stem pooling and fixed
``input // 32`` average-pool head: its plain forward and its MACs."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from benchmark.counts import conv_macs, out_size
from benchmark.reference.models import conv, linear, norm, pool


def forward(W: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor], x: torch.Tensor,
            arch: dict, train: bool, precision: str, taps: dict, settle: bool) -> torch.Tensor:
    def bn(t, name):
        return norm(arch, t, W, B, name, train, settle)

    out = bn(conv(x, W["conv1.weight"], 2, 3, precision), "bn1")
    out = pool(F.relu(out), arch["pooling"], 3, 2, 1)
    cin = 64
    for li, (planes, blocks) in enumerate(zip(arch["widths"], arch["blocks"])):
        for bi in range(blocks):
            pre = f"layer{li + 1}.{bi}."
            stride = 2 if (li > 0 and bi == 0) else 1
            y = F.relu(bn(conv(out, W[pre + "conv1.weight"], stride, 1, precision), pre + "bn1"))
            y = bn(conv(y, W[pre + "conv2.weight"], 1, 1, precision), pre + "bn2")
            if stride != 1 or cin != planes:
                out = bn(conv(out, W[pre + "down_conv.weight"], stride, 0, precision),
                         pre + "down_bn")
            out = F.relu(y + out)
            cin = planes
    win = arch["resolution"] // 32
    out = torch.flatten(F.avg_pool2d(out, win, win), 1)
    taps["head_input"] = out
    return linear(out, W["fc.weight"], W["fc.bias"], precision)


def macs(arch: dict, num_classes: int) -> Tuple[int, int]:
    r, cin = arch["resolution"], arch["in_channels"]
    h = out_size(r, 7, 2, 3)
    total = conv_macs(cin, 64, 7, h, h)
    h = out_size(h, 3, 2, 1)
    c = 64
    for li, (planes, blocks) in enumerate(zip(arch["widths"], arch["blocks"])):
        for bi in range(blocks):
            s = 2 if (li > 0 and bi == 0) else 1
            ho = out_size(h, 3, s, 1)
            total += conv_macs(c, planes, 3, ho, ho) + conv_macs(planes, planes, 3, ho, ho)
            if s != 1 or c != planes:
                total += conv_macs(c, planes, 1, ho, ho)
            h, c = ho, planes
    return total, c * num_classes
