"""Plain predict: what an encrypted request has to reveal.

uint8 NHWC images -> [0, 1] -> CLAHE (clip 1, 8 x 8 tiles) when the
recipe asks for it -> ``(x - mean) / std`` -> the model in eval mode,
batch norm from its running statistics. In float32 with TF32 off for the
reference; ``precision`` gives the lower-precision control.
"""

from __future__ import annotations

import torch

from benchmark.reference import image as I
from benchmark.reference.models import forward


def preprocess(u8: torch.Tensor, cfg: dict, mean: torch.Tensor, std: torch.Tensor):
    x = I.div(u8.permute(0, 3, 1, 2).float(), 255.0)
    if cfg["args"]["clahe"]:
        x = I.clahe(x, 1.0, 8)
    return (x - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)


@torch.no_grad()
def logits(weights, buffers, u8: torch.Tensor, cfg: dict, mean: torch.Tensor,
           std: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    x = preprocess(u8, cfg, mean, std)
    return forward(weights, buffers, x, cfg["architecture"], train=False,
                   precision=precision).float()
