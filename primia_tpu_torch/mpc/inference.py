"""Encrypted (SMPC) inference: the model's forward over secret shares.

Port of ``primia_tpu/mpc/inference.py``. The model owner folds batch norm
into a channelwise affine (``nn/core.py:bn_fold``, float32), keeps group
norm's gamma and beta as they are, encodes the weights in fixed point and
shares them, once. For each batch (or tile of it) the data owner
preprocesses in plaintext (u8 -> / 255 -> CLAHE, the kernel K3 -> ``(x -
mean) / std`` in float32), encodes and shares; two computing parties and
the dealer, simulated on one device on the leading party axis, run the
forward in share space (``mpc/engine.py``: Beaver convs, private group
norm, ReLUs and max-pool rounds on the protocol's comparison: SecureNN by
default, or the FSS comparison on kernel K4); only the logits are
revealed. With max pooling the stem pools before its ReLU (they commute),
which quarters the private ReLU's elements, as the reference does.

The port's models are ``nn.Module``s whose ``forward`` is plaintext; the
share-space forwards here walk their children in the JAX order, one a
family, as the JAX package runs its ``forward`` with ``E = MpcEngine``:
``resnet_forward`` (``primia_tpu/nn/resnet.py``), ``vgg_forward``
(``nn/vgg.py``: conv, bias and ReLU, 2x2 pools, the ``input // 32`` head,
the classifier; no dropout) and ``simpleconv_forward``
(``nn/simpleconv.py``: valid convs with biases, each resolution's pools,
folded batch norm or private group norm at 224 px). The pool<->ReLU swap
is ResNet's stem's alone: the JAX package's VGG deletes the flag and
SimpleConv ignores it.

Random streams: the model owner's, and per call of the predict function
and per tile the data owner's and the dealer's, each a ``torch.Generator``
on the device seeded from ``(stream, call, tile)``. Every batch gets fresh
masks and Beaver triples: the parties open ``x - a`` for each product, so
one mask ``a`` over two batches would reveal their difference. (The JAX
package's ``build_encrypted_predict`` draws the same streams at every call.)
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.engine import (MpcContext, MpcEngine, check_protocol,
                                         encode_and_share, reveal_and_decode)
from primia_tpu_torch.mpc.shares import AShare
from primia_tpu_torch.nn.core import Conv, Norm, bn_fold
from primia_tpu_torch.nn.simpleconv import SimpleConv
from primia_tpu_torch.nn.vgg import VGG
from primia_tpu_torch.ops.image import clahe
from primia_tpu_torch.ops.numerics import div

_MODEL, _DATA, _DEALER = 0, 1, 2


def folded_weights(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's weights as its owner shares them, by module name: conv
    ``weight`` and, where the conv has one, ``bias``; batch norm folded to
    ``scale`` and ``offset``; group norm's own ``weight`` and ``bias``
    (gamma and beta: its statistics depend on the input, so the engine
    normalises privately); each linear's ``weight`` and ``bias``. All
    float32."""
    out: Dict[str, torch.Tensor] = {}
    for name, m in model.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, Conv):
            out[pre + "weight"] = m.weight.detach().float()
            if m.bias is not None:
                out[pre + "bias"] = m.bias.detach().float()
        elif isinstance(m, Norm) and m.kind == "group":
            out[pre + "weight"] = m.weight.detach().float()
            out[pre + "bias"] = m.bias.detach().float()
        elif isinstance(m, Norm):
            f = bn_fold(m.weight.detach(), m.bias.detach(), m.running_mean, m.running_var,
                        m.eps)
            out[pre + "scale"], out[pre + "offset"] = f["scale"], f["offset"]
        elif isinstance(m, nn.Linear):
            out[pre + "weight"] = m.weight.detach().float()
            out[pre + "bias"] = m.bias.detach().float()
    return out


def _conv(E: MpcEngine, P: Dict[str, AShare], conv: Conv, name: str, x: AShare) -> AShare:
    """The conv, then its bias where it has one (``E.bias_add``)."""
    y = E.conv2d(x, P[name + ".weight"], conv.stride, conv.padding)
    return y if conv.bias is None else E.bias_add(y, P[name + ".bias"])


def _pool(E: MpcEngine, model: nn.Module, x: AShare, window: int, stride: int,
          padding: int = 0) -> AShare:
    """The model's pooling (max: tournament rounds of comparisons; avg: a
    public division)."""
    if model.pooling == "max":
        return E.max_pool(x, window=window, stride=stride, padding=padding)
    return E.avg_pool(x, window=window, stride=stride, padding=padding)


def _classifier(E: MpcEngine, P: Dict[str, AShare], x: AShare) -> AShare:
    """VGG's and SimpleConv's head: three linears, a ReLU after the first
    two."""
    for i in range(3):
        x = E.linear(x, P[f"classifier.{i}.weight"], P[f"classifier.{i}.bias"])
        if i < 2:
            x = E.relu(x)
    return x


def _norm(E: MpcEngine, P: Dict[str, AShare], norm: Norm, name: str, x: AShare) -> AShare:
    """Batch norm as its folded affine; group norm private, on the shared
    gamma and beta."""
    if norm.kind == "group":
        return E.group_norm(x, P[name + ".weight"], P[name + ".bias"], norm.groups, norm.eps)
    return E.affine(x, P[name + ".scale"], P[name + ".offset"])


def basic_block_forward(E: MpcEngine, P: Dict[str, AShare], block: nn.Module, pre: str,
                        x: AShare) -> AShare:
    """``primia_tpu/nn/resnet.py:_basic_block_forward`` in share space;
    ``pre`` names the block's weights in ``P`` (``"layer2.0."``)."""
    out = _norm(E, P, block.bn1, pre + "bn1", _conv(E, P, block.conv1, pre + "conv1", x))
    out = E.relu(out)
    out = _norm(E, P, block.bn2, pre + "bn2", _conv(E, P, block.conv2, pre + "conv2", out))
    identity = x
    if block.down_conv is not None:
        identity = _norm(E, P, block.down_bn, pre + "down_bn",
                         _conv(E, P, block.down_conv, pre + "down_conv", x))
    return E.relu(E.add(out, identity))


def resnet_forward(E: MpcEngine, P: Dict[str, AShare], model: nn.Module, x: AShare,
                   swap_pool_relu: bool) -> AShare:
    """``primia_tpu/nn/resnet.py:resnet_forward`` in share space: x is a
    (2, B, C, H, W) sharing, the result the logits' sharing."""
    out = _norm(E, P, model.bn1, "bn1", _conv(E, P, model.conv1, "conv1", x))

    def stem_pool(t):
        return _pool(E, model, t, 3, 2, 1)

    out = E.relu(stem_pool(out)) if swap_pool_relu else stem_pool(E.relu(out))
    for li in range(model.num_layers):
        for bi, block in enumerate(getattr(model, f"layer{li + 1}")):
            out = basic_block_forward(E, P, block, f"layer{li + 1}.{bi}.", out)
    win = model.input_size // 32
    out = E.flatten(E.avg_pool(out, window=win, stride=win))
    return E.linear(out, P["fc.weight"], P["fc.bias"])


def vgg_forward(E: MpcEngine, P: Dict[str, AShare], model: VGG, x: AShare) -> AShare:
    """``primia_tpu/nn/vgg.py:vgg16_forward`` in share space: 13 convs with
    their biases and ReLUs, a 2x2/s2 pool after each block, the
    ``input_size // 32`` average pool, the classifier."""
    ci = 0
    for c in model.cfg:
        if c == "M":
            x = _pool(E, model, x, 2, 2)
        else:
            x = E.relu(_conv(E, P, model.features[ci], f"features.{ci}", x))
            ci += 1
    win = model.input_size // 32
    return _classifier(E, P, E.flatten(E.avg_pool(x, window=win, stride=win)))


def simpleconv_forward(E: MpcEngine, P: Dict[str, AShare], model: SimpleConv,
                       x: AShare) -> AShare:
    """``primia_tpu/nn/simpleconv.py:simpleconv_forward`` in share space:
    each resolution's pattern of valid convs (bias, ReLU) and 2x2/s2 pools,
    at 224 px the norms after pools 1, 2 and 4, the classifier."""
    def conv(i, t):
        return E.relu(_conv(E, P, model.convs[i], f"convs.{i}", t))

    def pool(t):
        return _pool(E, model, t, 2, 2)

    if model.resolution == 28:
        for i in range(4):
            x = conv(i, x)
        x = pool(conv(5, pool(conv(4, pool(x)))))
    elif model.resolution == 224:
        for i in range(6):
            x = pool(conv(i, x))
            if str(i) in model.bns:
                x = _norm(E, P, model.bns[str(i)], f"bns.{i}", x)
    else:  # 512
        x = pool(pool(conv(0, x)))
        for i in range(1, 6):
            x = pool(conv(i, x))
        x = pool(x)
    return _classifier(E, P, E.flatten(x))


def model_forward(E: MpcEngine, P: Dict[str, AShare], model: nn.Module, x: AShare,
                  swap_pool_relu: bool) -> AShare:
    """The share-space forward of ``model``'s family."""
    if isinstance(model, VGG):
        return vgg_forward(E, P, model, x)
    if isinstance(model, SimpleConv):
        return simpleconv_forward(E, P, model, x)
    return resnet_forward(E, P, model, x, swap_pool_relu)


def build_encrypted_predict(model: nn.Module, args, mean, std, device, *,
                            precision_fractional: int = fixed.DEFAULT_FRAC_BITS,
                            protocol: str = "snn",
                            batch_tile: Optional[int] = None) -> Callable:
    """Returns ``predict(images_u8) -> logits`` over secret shares, called
    as the plain ``train/steps.py:build_predict_step``'s: (B, R, R, C)
    uint8 NHWC images in, (B, num_classes) float32 logits on ``device``
    out.

    Each call draws its own data-owner and dealer streams, numbered by the
    calls before it. ``batch_tile``: run the share-space forward
    ``batch_tile`` images at a time, each tile with its own streams; the
    tail is padded with copies of the first image and sliced off."""
    device = torch.device(device)
    check_protocol(protocol)
    frac = precision_fractional
    use_clahe = bool(args.clahe)
    swap = model.pooling == "max"  # max pooling commutes with relu: pool first
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device).reshape(1, -1, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device).reshape(1, -1, 1, 1)
    model.eval()
    weights = {k: v.to(device) for k, v in folded_weights(model).items()}
    shared = encode_and_share(S.stream(device, _MODEL), weights, frac)
    calls = itertools.count()

    @torch.inference_mode()
    def forward_tile(call: int, idx: int, imgs: torch.Tensor) -> torch.Tensor:
        # the data owner: preprocess in plaintext, then share
        x = div(imgs.permute(0, 3, 1, 2).float(), 255.0)
        if use_clahe:
            x = clahe(x, clip_limit=1.0, tiles=8, channels_first=True)
        x = (x - mean_t) / std_t
        xs = S.share(S.stream(device, _DATA, call, idx), fixed.encode(x, frac))
        E = MpcEngine(MpcContext(S.stream(device, _DEALER, call, idx), frac, protocol))
        return reveal_and_decode(model_forward(E, shared, model, xs, swap), frac).float()

    def predict(images_u8) -> torch.Tensor:
        imgs = images_u8 if isinstance(images_u8, torch.Tensor) else torch.from_numpy(
            np.array(images_u8))  # a copy: a cached data set is a read-only memory map
        imgs = imgs.to(device)
        B = imgs.shape[0]
        call = next(calls)
        if batch_tile is None or batch_tile >= B:
            return forward_tile(call, 0, imgs)
        pad = (-B) % batch_tile
        if pad:
            imgs = torch.cat([imgs, imgs[:1].expand(pad, *imgs.shape[1:])])
        outs = [forward_tile(call, i, t) for i, t in enumerate(imgs.split(batch_tile))]
        return torch.cat(outs)[:B]

    return predict
