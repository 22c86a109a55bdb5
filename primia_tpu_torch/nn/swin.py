"""Swin Transformer (Liu et al. 2021, "Swin Transformer: Hierarchical Vision
Transformer using Shifted Windows", arXiv:2103.14030) as an ``nn.Module``:
Swin-B, the published widths of ``swin_base_patch4_window12_384``
(embedding 128, depths 2-2-18-2, heads 4-8-16-32, head dim 32, MLP ratio 4,
qkv bias), with the authors' equations and parameter names:

- patch embedding: a 4x4 stride-4 conv with a bias, then layer norm; the
  tokens are a (B, H, W, C) view of its ``channels_last`` output;
- each block, pre-norm: ``x = x + attn(norm1(x))``, then
  ``x = x + mlp(norm2(x))``, the MLP ``fc2(gelu(fc1(x)))`` with the exact
  erf GELU;
- attention within windows of ``window`` x ``window`` tokens: ``qkv`` one
  linear layer with a bias, the logits ``q k^T / sqrt(32)`` plus the
  relative-position bias ``relative_position_bias_table[index]`` (a table
  of (2 window - 1)^2 x heads, gathered by a ``long`` index), plus, in the
  shifted blocks, the published region mask (-100 between tokens of
  different regions of the rolled map; the block keeps each window's
  region ids, ``attn_regions``); softmax, times ``v``, ``proj``;
- odd blocks roll the map by (-shift, -shift) before the window partition
  and back after the reverse, shift = window // 2; a stage whose map is not
  larger than the window attends over the whole map, unshifted. The roll,
  the partition and their inverses move whole tokens: ``norm1`` writes its
  rows straight into their window slot (the block's order), and ``norm2``
  reads the attention branch from its slot, adds it to the residual stream
  and normalises the sum; each passes the residual stream on, so its
  backward adds the stream's gradient in; all through
  ``ops/cuda_swin_norm.py:add_norm`` (``Norm(kind="layer")``), one kernel
  launch a direction on the card. Each layer norm's output takes the dtype
  of the op that reads it: autocast's for a linear layer under autocast,
  float32 for the residual stream and the head;
- patch merging after stages 1-3: the authors' concatenation x0, x1, x2,
  x3 of the four 2x2 neighbours, layer norm, a linear layer 4C -> 2C with
  no bias;
- head: layer norm, the mean over tokens, one linear layer.

The window is ``input_size // 32``: the published 12 at 384 px and 7 at
224 px; each stage's map is then 8, 4, 2 and 1 windows a side. Drop path is
0: the train step hands the model no generator, as for VGG-16's dropout.
Init as the authors': linear weights and the bias tables truncated normal
(std 0.02), biases zero, layer norms one and zero.

Every window attention goes through :func:`window_attention`, which the
attention module looks up by name at each call, on the port's kernels on
the card (``ops/cuda_attention.py``). Under a profiler each block's
attention half (from ``norm1`` to ``proj``) runs in the span
``swin.attention`` and its MLP half (from the residual add fused into
``norm2`` to the MLP's residual add) in ``swin.mlp``; both are forward-only
(autograd's thread runs the backward), and off the profiler they are the
shared no-op of ``utils.span``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch import utils
from primia_tpu_torch.nn.core import Conv, Norm
from primia_tpu_torch.ops import cuda_attention
from primia_tpu_torch.ops.cuda_swin_norm import window_partition

SWIN_B = {"embed_dim": 128, "depths": (2, 2, 18, 2), "num_heads": (4, 8, 16, 32)}
PATCH = 4
MLP_RATIO = 4


def refuse(model: nn.Module, path: str, missing: str) -> None:
    """Raises a ValueError naming the model (its ``model_name``: ``swin-b``,
    ``maxvit-b``) and what ``path`` lacks for it when ``model`` holds a
    window attention."""
    if any(isinstance(m, WindowAttention) for m in model.modules()):
        name = getattr(model, "model_name", type(model).__name__)
        raise ValueError(f"{path} does not take {name}: {missing}")


def relative_position_index(window: int) -> torch.Tensor:
    """(L, L) ``long``, L = window^2: row of ``relative_position_bias_table``
    for each pair of a window's tokens, (dy + w - 1) (2w - 1) + dx + w - 1."""
    ys, xs = torch.meshgrid(torch.arange(window), torch.arange(window), indexing="ij")
    coords = torch.stack([ys.flatten(), xs.flatten()])
    rel = coords[:, :, None] - coords[:, None, :] + (window - 1)
    return rel[0] * (2 * window - 1) + rel[1]


def shift_regions(resolution: int, window: int, shift: int) -> torch.Tensor:
    """(nW, L) ``int32``: the region of the unrolled map (the published
    three slices a side, numbered 0..8) that each token of each window of
    the map rolled by (-shift, -shift) comes from."""
    img = torch.zeros(1, resolution, resolution, 1, dtype=torch.int32)
    cuts = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for i, hs in enumerate(cuts):
        for j, ws in enumerate(cuts):
            img[:, hs, ws, :] = 3 * i + j
    return window_partition(img, window)[0, :, :, 0].contiguous()


def shift_mask(resolution: int, window: int, shift: int) -> torch.Tensor:
    """(nW, L, L) ``bool``: True where two tokens of a window of the map
    rolled by (-shift, -shift) come from different regions of the unrolled
    map (:func:`shift_regions`), the pairs a shifted block masks."""
    return cuda_attention.region_mask(shift_regions(resolution, window, shift))


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention within windows: ``q``, ``k``, ``v`` (B, nW, h, L, d), any
    strides; ``bias`` (h, L, L), the gathered relative-position bias;
    ``mask`` the windows' (nW, L) region ids (:func:`shift_regions`) or
    None. Returns softmax(q k^T / sqrt(d) + bias [+ MASK_VALUE where two
    tokens' regions differ]) v, (B, nW, h, L, d).

    ``ops/cuda_attention.py:window_attention``: on the card one forward and
    one backward launch of the port's kernels (bf16 under the train step's
    autocast, float32 in the eval and predict steps), the bias gradient
    summed on the card, the output a view of a (B, nW, L, h, d) buffer; on
    the CPU the explicit softmax. Each call counts in
    ``utils.counters["attention_calls"]`` while a profiler runs."""
    utils.count("attention_calls")
    return cuda_attention.window_attention(q, k, v, bias, mask)


def linear_input_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a linear layer reads ``x`` in: autocast's where autocast is
    on for ``x``'s device, else float32."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return torch.float32


def _linear(cin: int, cout: int, bias: bool = True) -> nn.Linear:
    lin = nn.Linear(cin, cout, bias=bias)
    nn.init.trunc_normal_(lin.weight, std=0.02)
    if bias:
        nn.init.zeros_(lin.bias)
    return lin


class WindowAttention(nn.Module):
    """``qkv``, the relative-position bias table and ``proj`` of one block;
    ``forward`` maps (B, nW, L, C) windows to (B, nW, L, C)."""

    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = _linear(dim, 3 * dim)
        self.proj = _linear(dim, dim)

    def forward(self, x: torch.Tensor, regions: Optional[torch.Tensor]) -> torch.Tensor:
        B, nW, L, C = x.shape
        h = self.heads
        # views of the qkv output, (B, nW, h, L, d): the kernels read them in place
        q, k, v = (t.transpose(2, 3)
                   for t in self.qkv(x).reshape(B, nW, L, 3, h, C // h).unbind(3))
        bias = self.relative_position_bias_table[self.relative_position_index].permute(2, 0, 1)
        o = window_attention(q, k, v, bias, regions)
        return self.proj(o.transpose(2, 3).reshape(B, nW, L, C))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1, self.fc2 = _linear(dim, hidden), _linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class SwinBlock(nn.Module):
    """One block on a (B, H, W, C) map of ``resolution`` a side; ``shift``
    is 0 (regular windows), ``window // 2`` (shifted) or ``GRID``
    (MaxViT's grid attention over a ``window`` x ``window`` grid,
    ``nn/maxvit.py``): the block's order of ``ops/cuda_swin_norm.py``."""

    def __init__(self, dim: int, heads: int, resolution: int, window: int, shift: int):
        super().__init__()
        if resolution <= window:
            window, shift = resolution, 0
        self.window, self.shift = window, shift
        self.norm1 = Norm(dim, "layer")
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = Norm(dim, "layer")
        self.mlp = Mlp(dim, MLP_RATIO * dim)
        self.register_buffer("attn_regions",
                             shift_regions(resolution, window, shift) if shift > 0 else None,
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        order, dtype = (self.window, self.shift), linear_input_dtype(x)
        with utils.span("swin.attention", x.device):
            x, y = self.norm1(x, out_order=order, out_dtype=dtype)
            y = self.attn(y, self.attn_regions)
        with utils.span("swin.mlp", x.device):
            x, y = self.norm2(x, branch=y, branch_order=order, out_dtype=dtype)
            x = x + self.mlp(y)
        return x


class PatchMerging(nn.Module):
    """(B, H, W, C) -> (B, H/2, W/2, 2C): the four 2x2 neighbours
    concatenated in the authors' order, layer norm, a linear layer with no
    bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = Norm(4 * dim, "layer")
        self.reduction = _linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]],
                      -1)
        return self.reduction(self.norm(x, out_dtype=linear_input_dtype(x))[1])


class Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, resolution: int, window: int,
                 merge: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            [SwinBlock(dim, heads, resolution, window, 0 if i % 2 == 0 else window // 2)
             for i in range(depth)])
        self.downsample = PatchMerging(dim) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, dim: int):
        super().__init__()
        self.proj = Conv(in_channels, dim, PATCH, PATCH, 0, bias=True)
        self.norm = Norm(dim, "layer")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.proj(x).permute(0, 2, 3, 1))[1]


class SwinTransformer(nn.Module):
    """``forward(x)`` takes (B, C, input_size, input_size) float images and
    returns the logits. ``pooling`` is ``"avg"``: the head's mean over
    tokens."""

    pooling = "avg"
    model_name = "swin-b"

    def __init__(self, num_classes: int = 3, in_channels: int = 3, input_size: int = 384,
                 embed_dim: int = SWIN_B["embed_dim"],
                 depths: Sequence[int] = SWIN_B["depths"],
                 num_heads: Sequence[int] = SWIN_B["num_heads"]):
        super().__init__()
        if input_size % 32:
            raise ValueError(f"swin-b needs a resolution that is a multiple of 32 (patch 4 and "
                             f"three merges, window resolution // 32), got {input_size}")
        self.in_channels, self.num_classes, self.input_size = in_channels, num_classes, input_size
        self.window = input_size // 32
        self.patch_embed = PatchEmbed(in_channels, embed_dim)
        res, dim = input_size // PATCH, embed_dim
        stages = []
        for i, (depth, heads) in enumerate(zip(depths, num_heads)):
            last = i == len(depths) - 1
            stages.append(Stage(dim, depth, heads, res, self.window, merge=not last))
            if not last:
                res, dim = res // 2, dim * 2
        self.layers = nn.ModuleList(stages)
        self.norm = Norm(dim, "layer")
        self.head = _linear(dim, num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape[-2:]) != (self.input_size, self.input_size):
            raise ValueError(f"swin-b was built for {self.input_size} px, got "
                             f"{tuple(x.shape[-2:])}")
        x = self.patch_embed(x)
        for stage in self.layers:
            x = stage(x)
        return self.head(self.norm(x)[1].mean((1, 2)))


def swin_b(**kw) -> SwinTransformer:
    return SwinTransformer(**kw)
