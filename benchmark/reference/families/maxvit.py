"""MaxViT (Tu et al. 2022, arXiv:2204.01697): its plain forward and its MACs,
from the configuration's ``architecture`` (``stem_width``, ``widths``,
``depths``, ``head_dim``, ``expansion``, ``se_ratio``, ``mlp_ratio``) and the
weights by the port's parameter names.

Written from the paper and the authors' release (``maxvit_base_tf_384``): a
stem of a 3 x 3 stride-2 convolution with a bias, batch norm, GELU and a
3 x 3 convolution with a bias; then each block three mixers, each added to
its input:

- MBConv: batch norm; a 1 x 1 convolution to ``expansion`` x C; batch norm,
  GELU; a 3 x 3 depthwise convolution (stride 2 in a stage's first block);
  batch norm, GELU; squeeze-excitation (the mean over the map, a linear
  layer to ``se_ratio`` x C, SiLU, a linear layer back, sigmoid, times the
  map); a 1 x 1 convolution to C with a bias; in a stage's first block the
  shortcut is a 2 x 2 average pool and a 1 x 1 convolution with a bias;
- block attention over P x P windows of neighbouring tokens, and grid
  attention over a P x P grid, whose window (a, b) holds the tokens at
  (i H / P + a, j W / P + b), each written below as its own reshape and
  permute: ``x + attn(ln1(x))``, then ``x + fc2(gelu(fc1(ln2(x))))``, the
  logits ``(q / sqrt(d)) k^T`` plus the relative-position bias of a P x P
  window, gathered from ``relative_position_bias_table`` by the pair's
  offset within the partition, the softmax and ``v`` as explicit products;

P is ``resolution // 32``. The head: the mean over tokens, layer norm, a
linear layer with tanh, the classifier.

``precision`` reaches every product: each convolution (the depthwise ones
through their own low-precision function below), every linear layer, and
``q k^T`` and the attention's product with ``v``, so that the float8 and
bfloat16 controls are as low as they say. Batch norm goes through the
configuration's ``norm`` (eps 1e-3), layer norm through ``F.layer_norm``
(eps 1e-5); they, the softmax, GELU, SiLU, the sigmoid and tanh stay
float32. In train mode each block runs under ``torch.utils.checkpoint``
(non-reentrant): a stage-1 grid attention's explicit logits at batch 48
are 0.77 GB in float32, and the whole reference keeps only the blocks'
inputs. Train-mode batch norm updates no running statistics here (the
norm clones them), so the recompute changes no state.

Departures from the published model, as the configuration states: drop
path is 0; symmetric padding where the release pads "same"; GELU the exact
erf form.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.counts import conv_macs, out_size
from benchmark.reference.families.swin import _linear, _matmul, relative_index
from benchmark.reference.models import _bf16, _quant, conv, linear, norm

LN_EPS = 1e-5


class _LowDepthwise(torch.autograd.Function):
    """A 3 x 3 depthwise convolution (padding 1) at a lower precision, as
    ``models._LowConv``: operands quantised, the result rounded to
    bfloat16, the gradient quantised as a gradient."""

    @staticmethod
    def forward(ctx, x, w, stride, kind):
        xq, wq = _quant(x, kind), _quant(w, kind)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, kind)
        return _bf16(F.conv2d(xq, wq, stride=stride, padding=1, groups=w.shape[0]))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, kind = ctx.conf
        gq = _quant(g, kind, grad=True)
        groups = wq.shape[0]
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, 1, groups=groups)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, 1, groups=groups)
        return _bf16(gx), gw, None, None


def _depthwise(x, w, stride, precision):
    if precision == "float32":
        return F.conv2d(x, w, stride=stride, padding=1, groups=w.shape[0])
    return _LowDepthwise.apply(x, w, stride, precision)


def _conv(x, W, name, stride, padding, precision):
    """A convolution by its weights' name, with its bias where it has one."""
    y = conv(x, W[name + ".weight"], stride, padding, precision)
    return y if name + ".bias" not in W else y + W[name + ".bias"].reshape(1, -1, 1, 1)


def _mbconv(x, arch, W, B, pre, stride, train, settle, precision):
    def bn(t, name):
        return norm(arch, t, W, B, pre + name, train, settle)

    short = x
    if stride > 1:
        short = _conv(F.avg_pool2d(x, stride, stride), W, pre + "shortcut", 1, 0, precision)
    y = F.gelu(bn(_conv(bn(x, "pre_norm"), W, pre + "conv1_1x1", 1, 0, precision), "norm1"))
    y = F.gelu(bn(_depthwise(y, W[pre + "conv2_kxk.weight"], stride, precision), "norm2"))
    s = y.mean(dim=(2, 3))
    s = F.silu(linear(s, W[pre + "se.fc1.weight"], W[pre + "se.fc1.bias"], precision))
    s = torch.sigmoid(linear(s, W[pre + "se.fc2.weight"], W[pre + "se.fc2.bias"], precision))
    return short + _conv(y * s[:, :, None, None], W, pre + "conv3_1x1", 1, 0, precision)


def _block_partition(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, p * p, C): p x p windows of neighbours."""
    B, H, Wd, C = x.shape
    return x.reshape(B, H // p, p, Wd // p, p, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, (H // p) * (Wd // p), p * p, C)


def _block_reverse(x: torch.Tensor, p: int, H: int, Wd: int) -> torch.Tensor:
    B, _, _, C = x.shape
    return x.reshape(B, H // p, Wd // p, p, p, C).permute(0, 1, 3, 2, 4, 5).reshape(
        B, H, Wd, C)


def _grid_partition(x: torch.Tensor, p: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, p * p, C): window (a, b) holds the tokens at
    (i H / p + a, j W / p + b), i, j < p, row-major in (i, j)."""
    B, H, Wd, C = x.shape
    return x.reshape(B, p, H // p, p, Wd // p, C).permute(0, 2, 4, 1, 3, 5).reshape(
        B, (H // p) * (Wd // p), p * p, C)


def _grid_reverse(x: torch.Tensor, p: int, H: int, Wd: int) -> torch.Tensor:
    B, _, _, C = x.shape
    return x.reshape(B, H // p, Wd // p, p, p, C).permute(0, 3, 1, 4, 2, 5).reshape(
        B, H, Wd, C)


PARTITIONS = {"attn_block": (_block_partition, _block_reverse),
              "attn_grid": (_grid_partition, _grid_reverse)}


def _attention(x, W, pre, heads, p, part, precision):
    """One attention half on (B, H, W, C) tokens: ``part`` names the
    partition (``attn_block`` or ``attn_grid``, which are also the
    weights' names)."""
    split, merge = PARTITIONS[part]
    pre = pre + part + "."
    B, H, Wd, C = x.shape
    d = C // heads
    y = F.layer_norm(x, (C,), W[pre + "norm1.weight"], W[pre + "norm1.bias"], LN_EPS)
    win = split(y, p)
    nW, L = win.shape[1], win.shape[2]
    qkv = _linear(win, W, pre + "attn.qkv", precision).reshape(B, nW, L, 3, heads, d)
    q, k, v = (qkv[:, :, :, i].transpose(2, 3) for i in range(3))  # (B, nW, h, L, d)
    logits = _matmul(q * d ** -0.5, k.transpose(-1, -2), precision)
    table = W[pre + "attn.relative_position_bias_table"]
    bias = table[relative_index(p).to(table.device).reshape(-1)].reshape(L, L, heads)
    o = _matmul(torch.softmax(logits + bias.permute(2, 0, 1), dim=-1), v, precision)
    o = _linear(o.transpose(2, 3).reshape(B, nW, L, C), W, pre + "attn.proj", precision)
    x = x + merge(o, p, H, Wd)
    h = F.layer_norm(x, (C,), W[pre + "norm2.weight"], W[pre + "norm2.bias"], LN_EPS)
    h = F.gelu(_linear(h, W, pre + "mlp.fc1", precision))
    return x + _linear(h, W, pre + "mlp.fc2", precision)


def _block(x, arch, W, B, pre, stride, p, train, settle, precision):
    """One MaxViT block on an NCHW map."""
    x = _mbconv(x, arch, W, B, pre + "conv.", stride, train, settle, precision).permute(
        0, 2, 3, 1)
    heads = x.shape[-1] // arch["head_dim"]
    for part in ("attn_block", "attn_grid"):
        x = _attention(x, W, pre, heads, min(p, x.shape[1]), part, precision)
    return x.permute(0, 3, 1, 2)


def forward(W: Dict[str, torch.Tensor], B: Dict[str, torch.Tensor], x: torch.Tensor,
            arch: dict, train: bool, precision: str, taps: dict, settle: bool) -> torch.Tensor:
    def bn(t, name):
        return norm(arch, t, W, B, name, train, settle)

    p = arch["resolution"] // 32
    y = F.gelu(bn(_conv(x, W, "stem.conv1", 2, 1, precision), "stem.norm1"))
    x = _conv(y, W, "stem.conv2", 1, 1, precision)
    for si, depth in enumerate(arch["depths"]):
        for bi in range(depth):
            args = (arch, W, B, f"stages.{si}.blocks.{bi}.", 2 if bi == 0 else 1, p, train,
                    settle, precision)
            if train:
                x = checkpoint(_block, x, *args, use_reentrant=False)
            else:
                x = _block(x, *args)
    x = x.mean(dim=(2, 3))
    x = F.layer_norm(x, (x.shape[-1],), W["norm.weight"], W["norm.bias"], LN_EPS)
    x = torch.tanh(linear(x, W["pre_logits.weight"], W["pre_logits.bias"], precision))
    taps["head_input"] = x
    return linear(x, W["head.weight"], W["head.bias"], precision)


def macs(arch: dict, num_classes: int) -> Tuple[int, int]:
    """(the convolutions' and the attention's MACs, the linear layers' MACs)
    of one image: the stem's two 3 x 3 convolutions; an MBConv's 1 x 1
    expansion (at its input's map), 3 x 3 depthwise (9 a channel and
    position), 1 x 1 projection and, in a stage's first block, its shortcut's
    1 x 1 convolution (at the output's map), its squeeze-excitation's two
    linear layers; each attention half on N tokens of width C 12 N C^2 in
    its linear layers (qkv 3, proj 1, MLP 2 x mlp_ratio) and 2 N L C in
    q k^T and the product with v (L = P^2 tokens a window); the head's
    pre-logits and classifier."""
    r, c = out_size(arch["resolution"], 3, 2, 1), arch["stem_width"]
    other = conv_macs(arch["in_channels"], c, 3, r, r) + conv_macs(c, c, 3, r, r)
    lin, p = 0, arch["resolution"] // 32
    for width, depth in zip(arch["widths"], arch["depths"]):
        for bi in range(depth):
            cin, mid = (c if bi == 0 else width), arch["expansion"] * width
            ro = out_size(r, 3, 2 if bi == 0 else 1, 1)
            other += conv_macs(cin, mid, 1, r, r) + 9 * mid * ro * ro
            other += conv_macs(mid, width, 1, ro, ro)
            if bi == 0:
                other += conv_macs(cin, width, 1, ro, ro)
            lin += 2 * mid * int(arch["se_ratio"] * width)
            n, L = ro * ro, min(p, ro) ** 2
            lin += 2 * n * width * width * (4 + 2 * arch["mlp_ratio"])
            other += 2 * 2 * n * L * width
            r = ro
        c = width
    return other, lin + c * c + c * num_classes
