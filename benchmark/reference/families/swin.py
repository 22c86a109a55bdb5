"""Swin Transformer (Liu et al. 2021, arXiv:2103.14030): its plain forward and
its MACs, from the configuration's ``architecture`` (``patch_size``,
``embed_dim``, ``depths``, ``num_heads``, ``mlp_ratio``) and the weights by
the port's parameter names.

Written from the paper and the authors' published model: a 4 x 4 patch
embedding with layer norm; each block ``x + attn(ln1(x))``, then
``x + fc2(gelu(fc1(ln2(x))))`` (exact erf GELU); attention within windows of
``resolution // 32`` tokens a side (12 at 384 px), logits ``(q / sqrt(d))
k^T`` plus the relative-position bias, gathered from
``attn.relative_position_bias_table`` by an index built here, plus, in odd
blocks, the region mask of the map rolled by half a window; the softmax
and ``v`` as explicit products; the map rolled back; a stage whose map is
not larger than the window attends over all of it, unshifted; patch
merging (x0, x1, x2, x3, layer norm, a linear layer without bias) after
every stage but the last; layer norm, the mean over tokens, the head.

``precision`` reaches every product: the patch embedding, every linear
layer, and ``q k^T`` and the attention's product with ``v``
(``models._quant``), so that the float8 and bfloat16 controls are as low as
they say. Layer norm, softmax and GELU stay float32. In train mode each
block runs under ``torch.utils.checkpoint`` (non-reentrant): the explicit
logits of one stage-1 block of a 64 x 384^2 batch are 1.36 GB in float32,
and the whole reference keeps only the blocks' inputs.

Departures from the published model, as the configuration states: drop
path is 0 (a train-time draw in the authors' recipe; the port's train step
hands its model no generator); the mask adds -100 to the logits of pairs
from different regions, as published (not -inf).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.counts import conv_macs
from benchmark.reference.models import _bf16, _quant, conv, linear, norm

MASK_VALUE = -100.0


class _LowMatmul(torch.autograd.Function):
    """``a @ b`` of two activations at a lower precision: operands
    quantised, the product rounded to bfloat16, the gradients' operand
    quantised as a gradient and both gradients rounded to bfloat16."""

    @staticmethod
    def forward(ctx, a, b, kind):
        aq, bq = _quant(a, kind), _quant(b, kind)
        ctx.save_for_backward(aq, bq)
        ctx.kind = kind
        return _bf16(aq @ bq)

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _quant(g, ctx.kind, grad=True)
        return _bf16(gq @ bq.transpose(-1, -2)), _bf16(aq.transpose(-1, -2) @ gq), None


def _matmul(a, b, precision):
    return a @ b if precision == "float32" else _LowMatmul.apply(a, b, precision)


def _linear(x, W, name, precision):
    """A linear layer on the last dimension of ``x``, by its weights' name."""
    y = linear(x.reshape(-1, x.shape[-1]), W[name + ".weight"],
               W.get(name + ".bias", 0.0), precision)
    return y.reshape(*x.shape[:-1], y.shape[-1])


def window_geometry(arch: dict, resolution: int) -> Tuple[int, int]:
    """(window, shift of the odd blocks) of a stage whose map is
    ``resolution`` tokens a side."""
    window = arch["resolution"] // 32
    if resolution <= window:
        return resolution, 0
    return window, window // 2


def relative_index(window: int) -> torch.Tensor:
    """(L, L): the table row of the pair (i, j) of a window's tokens,
    numbered row-major: (y_i - y_j + w - 1) (2 w - 1) + x_i - x_j + w - 1."""
    pos = torch.arange(window * window)
    y, x = pos // window, pos % window
    dy = y[:, None] - y[None, :] + window - 1
    dx = x[:, None] - x[None, :] + window - 1
    return dy * (2 * window - 1) + dx


def _windows(x: torch.Tensor, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, w * w, C)."""
    B, H, Wd, C = x.shape
    return x.reshape(B, H // w, w, Wd // w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // w) * (Wd // w), w * w, C)


def _unwindows(x: torch.Tensor, w: int, H: int) -> torch.Tensor:
    B, _, _, C = x.shape
    return x.reshape(B, H // w, H // w, w, w, C).permute(0, 1, 3, 2, 4, 5).reshape(B, H, H, C)


def region_mask(resolution: int, w: int, s: int) -> torch.Tensor:
    """(nW, L, L) bool, True where two tokens of a window of the rolled map
    come from different regions: the published labelling, three slices a
    side of the rolled map, (0, -w), (-w, -s), (-s, end)."""
    label = torch.zeros(resolution, resolution)
    cuts = (slice(0, -w), slice(-w, -s), slice(-s, None))
    n = 0
    for hs in cuts:
        for ws in cuts:
            label[hs, ws] = n
            n += 1
    lab = _windows(label[None, :, :, None], w)[0, :, :, 0]
    return lab[:, :, None] != lab[:, None, :]


def _block(x, arch, W, pre, heads, w, s, precision):
    B, H, _, C = x.shape
    d = C // heads
    y = norm(arch, x, W, None, pre + "norm1", True)
    if s:
        y = torch.roll(y, shifts=(-s, -s), dims=(1, 2))
    win = _windows(y, w)
    nW, L = win.shape[1], win.shape[2]
    qkv = _linear(win, W, pre + "attn.qkv", precision).reshape(B, nW, L, 3, heads, d)
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, nW, h, L, d)
    logits = _matmul(q * d ** -0.5, k.transpose(-1, -2), precision)
    table = W[pre + "attn.relative_position_bias_table"]
    bias = table[relative_index(w).to(table.device).reshape(-1)].reshape(L, L, heads)
    logits = logits + bias.permute(2, 0, 1)
    if s:
        masked = region_mask(H, w, s).to(x.device)
        logits = logits + torch.where(masked, MASK_VALUE, 0.0)[None, :, None]
    o = _matmul(torch.softmax(logits, dim=-1), v, precision)
    o = _linear(o.transpose(2, 3).reshape(B, nW, L, C), W, pre + "attn.proj", precision)
    o = _unwindows(o, w, H)
    if s:
        o = torch.roll(o, shifts=(s, s), dims=(1, 2))
    x = x + o
    h = norm(arch, x, W, None, pre + "norm2", True)
    h = F.gelu(_linear(h, W, pre + "mlp.fc1", precision))
    return x + _linear(h, W, pre + "mlp.fc2", precision)


def forward(W: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor], x: torch.Tensor,
            arch: dict, train: bool, precision: str, taps: dict, settle: bool) -> torch.Tensor:
    p = arch["patch_size"]
    y = conv(x, W["patch_embed.proj.weight"], p, 0, precision)
    y = y + W["patch_embed.proj.bias"].reshape(1, -1, 1, 1)
    x = norm(arch, y.permute(0, 2, 3, 1), W, B, "patch_embed.norm", train)
    res = arch["resolution"] // p
    n_stages = len(arch["depths"])
    for si, (depth, heads) in enumerate(zip(arch["depths"], arch["num_heads"])):
        w, shift = window_geometry(arch, res)
        for bi in range(depth):
            args = (arch, W, f"layers.{si}.blocks.{bi}.", heads, w, shift if bi % 2 else 0,
                    precision)
            if train:
                x = checkpoint(_block, x, *args, use_reentrant=False)
            else:
                x = _block(x, *args)
        if si < n_stages - 1:
            pre = f"layers.{si}.downsample."
            x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                           x[:, 1::2, 1::2]], -1)
            x = _linear(norm(arch, x, W, B, pre + "norm", train), W, pre + "reduction",
                        precision)
            res //= 2
    x = norm(arch, x, W, B, "norm", train).mean(dim=(1, 2))
    taps["head_input"] = x
    return linear(x, W["head.weight"], W["head.bias"], precision)


def macs(arch: dict, num_classes: int) -> Tuple[int, int]:
    """(the patch embedding's and the window attention's MACs, the linear
    layers' MACs) of one image: a block on N tokens of width C is 12 N C^2
    in its linear layers (qkv 3, proj 1, MLP 2 x mlp_ratio) and 2 N L C in
    q k^T and the product with v (L tokens a window); a merge of N tokens
    2 N C^2."""
    p, r = arch["patch_size"], arch["resolution"] // arch["patch_size"]
    c = arch["embed_dim"]
    other = conv_macs(arch["in_channels"], c, p, r, r)
    lin = 0
    n_stages = len(arch["depths"])
    for si, depth in enumerate(arch["depths"]):
        n = r * r
        w, _ = window_geometry(arch, r)
        lin += depth * n * c * c * (4 + 2 * arch["mlp_ratio"])
        other += depth * 2 * n * w * w * c
        if si < n_stages - 1:
            lin += 2 * n * c * c
            r, c = r // 2, c * 2
    return other, lin + c * num_classes
