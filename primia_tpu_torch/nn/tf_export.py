"""TensorFlow serving bridge: export trained models as TF SavedModels.

Port of ``primia_tpu/nn/tf_export.py``. The JAX package stages its
jitted eval function out through ``jax2tf``, which only JAX has. Here the
same function, ``train/steps.py:build_eval_step``'s (center crop to the
train resolution, ``normalize_only``, the model in eval mode with its
running statistics), is written in TensorFlow ops over the model's
frozen weights, NHWC, for the three families (``nn/resnet.py``,
``nn/vgg.py``, ``nn/simpleconv.py``, batch or group norm), and saved as a
SavedModel whose ``serve`` signature maps uint8 images to float32
logits. TF-Serving or TFLite can host it without PyTorch.

TensorFlow is optional and imported lazily, here only; :func:`tf_available`
probes for it. The model comes from the port's modules, or from a
checkpoint (``train/checkpoint.py``'s npz format, which both packages
read and write).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from primia_tpu_torch.nn.core import Conv, Norm, bn_fold
from primia_tpu_torch.nn.resnet import ResNet
from primia_tpu_torch.nn.simpleconv import SimpleConv
from primia_tpu_torch.nn.swin import refuse
from primia_tpu_torch.nn.vgg import VGG


def tf_available() -> bool:
    """Whether TensorFlow imports (the reference's ``dependency_check``)."""
    try:
        import tensorflow  # noqa: F401

        return True
    except Exception:
        return False


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


class _Ops:
    """The model's layers in TF ops on NHWC float32, weights as constants."""

    def __init__(self, tf):
        self.tf = tf

    def conv(self, conv: Conv, x):
        tf = self.tf
        w = np.transpose(_np(conv.weight), (2, 3, 1, 0))  # OIHW -> HWIO
        p = conv.padding
        y = tf.nn.conv2d(x, w, strides=conv.stride,
                         padding=[[0, 0], [p, p], [p, p], [0, 0]] if p else "VALID")
        return y if conv.bias is None else y + _np(conv.bias)

    def norm(self, norm: Norm, x):
        tf = self.tf
        if norm.kind == "batch":
            f = bn_fold(norm.weight.detach(), norm.bias.detach(), norm.running_mean,
                        norm.running_var, norm.eps)
            return x * _np(f["scale"]) + _np(f["offset"])
        # nn/core.py:group_norm: per-example statistics over each group of
        # neighbouring channels, then the affine
        C = x.shape[-1]
        G = min(norm.groups, C)
        s = tf.shape(x)
        xg = tf.reshape(x, tf.stack([s[0], s[1], s[2], G, C // G]))
        mean = tf.reduce_mean(xg, axis=[1, 2, 4], keepdims=True)
        var = tf.maximum(tf.reduce_mean(tf.square(xg), axis=[1, 2, 4], keepdims=True)
                         - tf.square(mean), 0.0)
        xhat = tf.reshape((xg - mean) * tf.math.rsqrt(var + norm.eps), s)
        return xhat * _np(norm.weight) + _np(norm.bias)

    def pool(self, x, kind: str, window: int, stride: int, padding: int = 0):
        """Max pool, or the average over the whole window, padding counted
        (``nn/core.py:avg_pool``)."""
        tf = self.tf
        if padding:
            pads = [[0, 0], [padding, padding], [padding, padding], [0, 0]]
            x = tf.pad(x, pads, constant_values=-np.inf if kind == "max" else 0.0)
        fn = tf.nn.max_pool2d if kind == "max" else tf.nn.avg_pool2d
        return fn(x, window, stride, "VALID")

    def linear(self, lin: nn.Linear, x):
        return self.tf.matmul(x, _np(lin.weight).T) + _np(lin.bias)

    def flatten(self, x):
        """torch.flatten of the NCHW map: channels outermost."""
        tf = self.tf
        x = tf.transpose(x, [0, 3, 1, 2])
        return tf.reshape(x, [-1, int(np.prod(x.shape[1:]))])

    def mlp_head(self, classifier, x):
        x = self.flatten(x)
        for lin in classifier[:-1]:
            x = self.tf.nn.relu(self.linear(lin, x))
        return self.linear(classifier[-1], x)

    # ---- the families
    def resnet(self, m: ResNet, x):
        relu = self.tf.nn.relu
        out = self.norm(m.bn1, self.conv(m.conv1, x))

        def stem_pool(t):
            return self.pool(t, m.pooling, 3, 2, 1)

        out = relu(stem_pool(out)) if m.swap_pool_relu else stem_pool(relu(out))
        for li in range(m.num_layers):
            for b in getattr(m, f"layer{li + 1}"):
                y = relu(self.norm(b.bn1, self.conv(b.conv1, out)))
                y = self.norm(b.bn2, self.conv(b.conv2, y))
                identity = out if b.down_conv is None else \
                    self.norm(b.down_bn, self.conv(b.down_conv, out))
                out = relu(y + identity)
        win = m.input_size // 32
        return self.linear(m.fc, self.flatten(self.pool(out, "avg", win, win)))

    def vgg(self, m: VGG, x):
        convs = iter(m.features)
        for c in m.cfg:
            x = self.pool(x, m.pooling, 2, 2) if c == "M" else \
                self.tf.nn.relu(self.conv(next(convs), x))
        win = m.input_size // 32
        return self.mlp_head(m.classifier, self.pool(x, "avg", win, win))

    def simpleconv(self, m: SimpleConv, x):
        def conv(i, t):
            return self.tf.nn.relu(self.conv(m.convs[i], t))

        def pool(t):
            return self.pool(t, m.pooling, 2, 2)

        if m.resolution == 28:
            for i in range(4):
                x = conv(i, x)
            x = pool(conv(5, pool(conv(4, pool(x)))))
        elif m.resolution == 224:
            for i in range(6):
                x = pool(conv(i, x))
                if str(i) in m.bns:
                    x = self.norm(m.bns[str(i)], x)
        else:  # 512
            x = pool(pool(conv(0, x)))
            for i in range(1, 6):
                x = pool(conv(i, x))
            x = pool(x)
        return self.mlp_head(m.classifier, x)

    def forward(self, model: nn.Module, x):
        if isinstance(model, ResNet):
            return self.resnet(model, x)
        if isinstance(model, VGG):
            return self.vgg(model, x)
        if isinstance(model, SimpleConv):
            return self.simpleconv(model, x)
        raise TypeError(f"no TF forward for {type(model).__name__}")


def make_serving_fn(model: nn.Module, mean, std,
                    train_resolution: Optional[int] = None) -> Callable:
    """TF-ops inference closure over the model's frozen weights:
    ``images_u8 (B, R, R, C) uint8 -> logits (B, num_classes) float32``,
    ``build_eval_step``'s preprocessing (center crop to the train
    resolution, per-channel normalise) and the eval-mode forward. A model
    with window attention (Swin-B, MaxViT-B) raises a ValueError: the
    exporter has no window attention, layer norm or GELU."""
    refuse(model, "TF export", "the exporter has no window attention, layer norm or GELU")
    import tensorflow as tf

    ops = _Ops(tf)
    size = int(train_resolution or model.input_size)
    mean = np.asarray(mean, np.float32).reshape(1, 1, 1, -1)
    std = np.asarray(std, np.float32).reshape(1, 1, 1, -1)

    def serve(images_u8):
        x = tf.convert_to_tensor(images_u8)
        off = (x.shape[1] - size) // 2
        x = x[:, off:off + size, off:off + size, :]
        x = (tf.cast(x, tf.float32) / 255.0 - mean) / std
        return tf.cast(ops.forward(model, x), tf.float32)

    return serve


def to_tf_function(model: nn.Module, mean, std, *, batch_size: Optional[int] = None,
                   train_resolution: Optional[int] = None):
    """``tf.function`` computing logits from a uint8 NHWC image batch of the
    model's input size. ``batch_size=None`` exports a dynamic leading
    dimension."""
    import tensorflow as tf

    serve = make_serving_fn(model, mean, std, train_resolution)
    res = int(model.input_size)
    spec = tf.TensorSpec([batch_size, res, res, model.in_channels], tf.uint8, name="images")
    return tf.function(serve, input_signature=[spec], autograph=False)


def export_saved_model(model: nn.Module, mean, std, path: str, *,
                       batch_size: Optional[int] = None,
                       train_resolution: Optional[int] = None) -> str:
    """Write a TF SavedModel whose ``serve`` signature maps uint8 images
    to logits. Returns ``path``."""
    import tensorflow as tf

    fn = to_tf_function(model, mean, std, batch_size=batch_size,
                        train_resolution=train_resolution)
    module = tf.Module()
    module.serve = fn
    tf.saved_model.save(module, path, signatures={"serving_default": fn})
    return path


def export_checkpoint(ckpt_path: str, out_dir: str, batch_size: Optional[int] = None) -> str:
    """Load a training checkpoint (``args`` and ``val_mean_std`` inside, the
    inference CLI's contract) and export it as a SavedModel."""
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt

    state = ckpt.load_model(ckpt_path)
    args = state["args"]
    mean, std = state["val_mean_std"]
    msd = state["model_state_dict"]
    model = create_model(args, device="cpu")
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    return export_saved_model(model, mean, std, out_dir, batch_size=batch_size,
                              train_resolution=args.train_resolution)


def load_saved_model(path: str) -> Callable:
    """Reload an exported SavedModel as ``images_u8 -> logits (np)``."""
    import tensorflow as tf

    mod = tf.saved_model.load(path)

    def run(images_u8) -> np.ndarray:
        return np.asarray(mod.serve(tf.constant(np.asarray(images_u8))))

    return run
