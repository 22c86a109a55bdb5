"""MaxViT (Tu et al. 2022, "MaxViT: Multi-Axis Vision Transformer",
arXiv:2204.01697) as an ``nn.Module``: MaxViT-B, the published widths of the
authors' release (``maxvit_base_tf_384``): stem 64, stage widths
96-192-384-768, blocks 2-6-14-2, head dim 32 (3, 6, 12 and 24 heads), MBConv
expansion 4, squeeze-excitation to a quarter of the block's width:

- stem: a 3x3 stride-2 conv with a bias, batch norm, GELU, a 3x3 conv with
  a bias;
- each block, three mixers in a row, each with its residual add:

  1. MBConv: batch norm; a 1x1 conv to 4C; batch norm, GELU; a 3x3
     depthwise conv (stride 2 in a stage's first block); batch norm, GELU;
     squeeze-excitation (the mean over the map, a linear layer 4C -> C/4,
     SiLU, a linear layer C/4 -> 4C, sigmoid, the product with the map); a
     1x1 conv to C with a bias. A stage's first block adds the shortcut of
     a 2x2 average pool and a 1x1 conv with a bias, the others x itself;
  2. block attention: ``nn/swin.py:SwinBlock`` over non-overlapping P x P
     windows, unshifted and unmasked: ``x + attn(norm1(x))``, then
     ``x + mlp(norm2(x))``;
  3. grid attention: the same block over a P x P grid (the order
     ``(P, GRID)`` of ``ops/cuda_swin_norm.py``): window (a, b) holds the
     tokens at (i H / P + a, j W / P + b), i, j < P, spread over the whole
     map;

  both attention halves with the learned relative-position bias of a P x P
  window, ``swin.relative_position_index(P)`` over the partition's own
  coordinates, and every call through ``swin.window_attention``;
- head: the mean over tokens, layer norm, a linear layer with tanh (the
  pre-logits), the classifier.

The partition P is ``input_size // 32``: the published 12 at 384 px, where
the stages' maps are 96, 48, 24 and 12 tokens a side. Batch norm has eps
1e-3, as the authors' TensorFlow release; layer norm 1e-5. Assumed where the
paper is silent: the exact erf GELU, symmetric padding (the release pads
"same"), drop path 0 (as Swin-B's: the train step hands its model no
generator). Init: convolutions He normal (fan out), linear layers
PyTorch's default, norms one and zero, the attention blocks as Swin's.

The MBConv runs on the NCHW map (``channels_last`` in memory on the card),
the attention halves on its (B, H, W, C) view of the same memory: no copy
between them. Under a profiler each block's mixers run in the spans
``maxvit.mbconv``, ``maxvit.block`` and ``maxvit.grid``, each the whole mixer
with its residual add, forward only (autograd's thread runs the backward),
around the attention blocks' own ``swin.attention`` and ``swin.mlp``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch import utils
from primia_tpu_torch.nn.core import Conv, Norm, avg_pool
from primia_tpu_torch.nn.swin import SwinBlock
from primia_tpu_torch.ops.cuda_swin_norm import GRID

MAXVIT_B = {"stem_width": 64, "widths": (96, 192, 384, 768), "depths": (2, 6, 14, 2)}
HEAD_DIM = 32
EXPANSION = 4
SE_RATIO = 0.25
BN_EPS = 1e-3


class SqueezeExcite(nn.Module):
    """(B, C, H, W) -> the map times sigmoid(fc2(silu(fc1(its mean over the
    map)))), a gate a channel."""

    def __init__(self, channels: int, reduced: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(channels, reduced), nn.Linear(reduced, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = torch.sigmoid(self.fc2(F.silu(self.fc1(x.mean((2, 3))))))
        return x * gate[:, :, None, None]


class MBConv(nn.Module):
    """The convolution mixer with its residual add, (B, cin, H, W) ->
    (B, cout, H / stride, W / stride); a stage's first block (stride 2)
    changes the width, the others keep it."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        mid = EXPANSION * cout
        self.stride = stride
        self.pre_norm = Norm(cin, "batch", BN_EPS)
        self.conv1_1x1 = Conv(cin, mid, 1)
        self.norm1 = Norm(mid, "batch", BN_EPS)
        self.conv2_kxk = Conv(mid, mid, 3, stride, 1, groups=mid)
        self.norm2 = Norm(mid, "batch", BN_EPS)
        self.se = SqueezeExcite(mid, int(SE_RATIO * cout))
        self.conv3_1x1 = Conv(mid, cout, 1, bias=True)
        self.shortcut = Conv(cin, cout, 1, bias=True) if stride > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        short = x if self.shortcut is None else self.shortcut(avg_pool(x, self.stride,
                                                                        self.stride))
        y = F.gelu(self.norm1(self.conv1_1x1(self.pre_norm(x))))
        y = F.gelu(self.norm2(self.conv2_kxk(y)))
        return short + self.conv3_1x1(self.se(y))


class MaxViTBlock(nn.Module):
    """MBConv, block attention and grid attention on a map of
    ``resolution`` a side after the MBConv's stride."""

    def __init__(self, cin: int, cout: int, resolution: int, partition: int, stride: int):
        super().__init__()
        heads = cout // HEAD_DIM
        self.conv = MBConv(cin, cout, stride)
        self.attn_block = SwinBlock(cout, heads, resolution, partition, 0)
        self.attn_grid = SwinBlock(cout, heads, resolution, partition, GRID)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with utils.span("maxvit.mbconv", x.device):
            x = self.conv(x)
        x = x.permute(0, 2, 3, 1)
        with utils.span("maxvit.block", x.device):
            x = self.attn_block(x)
        with utils.span("maxvit.grid", x.device):
            x = self.attn_grid(x)
        return x.permute(0, 3, 1, 2)


class Stage(nn.Module):
    def __init__(self, cin: int, cout: int, depth: int, resolution: int, partition: int):
        super().__init__()
        self.blocks = nn.ModuleList(
            [MaxViTBlock(cin if i == 0 else cout, cout, resolution, partition,
                         2 if i == 0 else 1) for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class Stem(nn.Module):
    def __init__(self, in_channels: int, width: int):
        super().__init__()
        self.conv1 = Conv(in_channels, width, 3, 2, 1, bias=True)
        self.norm1 = Norm(width, "batch", BN_EPS)
        self.conv2 = Conv(width, width, 3, 1, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.gelu(self.norm1(self.conv1(x))))


class MaxViT(nn.Module):
    """``forward(x)`` takes (B, C, input_size, input_size) float images and
    returns the logits. ``pooling`` is ``"avg"``: the head's mean over
    tokens."""

    pooling = "avg"
    model_name = "maxvit-b"

    def __init__(self, num_classes: int = 3, in_channels: int = 3, input_size: int = 384,
                 stem_width: int = MAXVIT_B["stem_width"],
                 widths: Sequence[int] = MAXVIT_B["widths"],
                 depths: Sequence[int] = MAXVIT_B["depths"]):
        super().__init__()
        if input_size % 32:
            raise ValueError(f"maxvit-b needs a resolution that is a multiple of 32 (a stride-2 "
                             f"stem and stages, partition resolution // 32), got {input_size}")
        self.in_channels, self.num_classes, self.input_size = in_channels, num_classes, input_size
        self.partition = input_size // 32
        self.stem = Stem(in_channels, stem_width)
        res, cin, stages = input_size // 2, stem_width, []
        for width, depth in zip(widths, depths):
            res //= 2
            stages.append(Stage(cin, width, depth, res, self.partition))
            cin = width
        self.stages = nn.ModuleList(stages)
        self.norm = Norm(cin, "layer")
        self.pre_logits = nn.Linear(cin, cin)
        self.head = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) != (self.input_size, self.input_size):
            raise ValueError(f"maxvit-b was built for {self.input_size} px, got "
                             f"{tuple(x.shape[-2:])}")
        x = self.stem(x)
        for stage in self.stages:
            x = stage(x)
        pooled = x.float().mean((2, 3))
        y = self.norm(pooled[:, None, None, :])[1][:, 0, 0]
        return self.head(torch.tanh(self.pre_logits(y)))


def maxvit_b(**kw) -> MaxViT:
    return MaxViT(**kw)
