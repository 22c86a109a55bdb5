"""The train, eval and predict steps.

Port of ``primia_tpu/train/steps.py``. The JAX package compiles each
step into one XLA program; here each is a function of eager PyTorch ops
on the device, with the same order of work: augmentation, mixup, the
forward and backward pass and the optimizer update (train step);
center crop, normalise and the eval-mode forward (eval step); CLAHE,
normalise and the eval-mode forward (predict step). The learning rate is
an argument of the train step, so the schedule changes it per epoch.

Loss selection mirrors ``train.py:304-324``: one-hot soft cross entropy
when mixup (or federated class weighting) is on, otherwise hard-label
cross entropy, both optionally class-weighted.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from primia_tpu_torch.ops.augment import AugmentConfig, build_augment_fn, normalize_only
from primia_tpu_torch.ops.image import clahe
from primia_tpu_torch.ops.numerics import div
from primia_tpu_torch.train import losses
from primia_tpu_torch.utils import count_h2d, span


def resolve_compute_dtype(args, device) -> torch.dtype:
    """``"auto"`` -> bfloat16 on CUDA (the accelerator's mixed precision,
    as the JAX package picks bfloat16 on the TPU) and float32 on the CPU;
    explicit names pass through."""
    name = getattr(args, "compute_dtype", "auto")
    if name == "auto":
        return torch.bfloat16 if torch.device(device).type == "cuda" else torch.float32
    return getattr(torch, name)


def uses_onehot_loss(args) -> bool:
    return bool(args.mixup or (args.train_federated and args.weight_classes))


def _full_f32(device: torch.device) -> None:
    """Float32 convolutions and matrix products in full float32 on CUDA
    (process-wide): cuDNN's TF32 default keeps about three decimal
    digits, and the JAX steps compute in float32 where they do."""
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")


def _on(device: torch.device, a, dtype=None) -> Optional[torch.Tensor]:
    """A numpy array or tensor on ``device`` (numpy is copied: a cached
    dataset is a read-only memory map). A host array copied onto the
    device counts in ``h2d_copies`` while a profiler runs."""
    if a is None:
        return None
    host = not isinstance(a, torch.Tensor)
    t = torch.from_numpy(np.array(a)) if host else a
    if host or (t.device.type == "cpu" and device.type != "cpu"):
        count_h2d()
    return t.to(device=device, dtype=dtype)


def _class_weights(args, class_weights, device) -> Optional[torch.Tensor]:
    if args.weight_classes and class_weights is not None:
        return torch.as_tensor(np.asarray(class_weights, np.float32), device=device)
    return None


def _center_crop(x: torch.Tensor, size: int) -> torch.Tensor:
    """Center crop of (B, R, R, C) images to ``size``."""
    H = x.shape[1]
    if H == size:
        return x
    off = (H - size) // 2
    return x[:, off:off + size, off:off + size, :]


def build_train_step(model: torch.nn.Module, optimizer, args, mean, std,
                     class_weights: Optional[np.ndarray] = None, device="cuda") -> Callable:
    """Returns ``step(gen, images_u8, labels, mask, lr) -> loss``.

    ``images_u8``: (B, inference_res, inference_res, C) uint8 (numpy, or a
    tensor, best already on ``device``); ``gen`` the ``torch.Generator``
    on ``device`` that the augmentation and mixup draw from. The step
    runs augmentation, mixup, the forward and backward pass in train mode
    and ``optimizer.update`` on the device, and returns the loss as a
    device tensor (no host sync). ``mask`` zeroes padded rows' loss
    (padded rows do enter the BN batch statistics).

    Under a profiler, ``utils.span`` names the step (``train.step``) and
    its phases: ``train.augment`` (the augmentation with the label and
    mask copies), ``train.mixup``, ``train.forward`` (with the loss),
    ``train.backward`` and ``train.optimizer``.

    Precision: the compute dtype (:func:`resolve_compute_dtype`) is
    bfloat16 on CUDA by default: convolutions and the fc run in bfloat16
    under autocast, while the BN statistics, the loss, the master
    parameters and the optimizer state stay float32. Under float32, TF32
    is off for cuDNN and matrix products (process-wide), so the card can
    be held against the CPU.
    """
    device = torch.device(device)
    cfg = AugmentConfig.from_args(args)
    in_channels = model.in_channels
    augment = build_augment_fn(cfg, mean, std, in_channels, device)
    w = _class_weights(args, class_weights, device)
    onehot = uses_onehot_loss(args)
    nc = model.num_classes
    cdtype = resolve_compute_dtype(args, device)
    _full_f32(device)

    def step(gen: torch.Generator, images_u8, labels, mask, lr: float) -> torch.Tensor:
        with span("train.step", device):
            model.train()
            with span("train.augment", device):
                x = augment(gen, _on(device, images_u8))
                labels = _on(device, labels, torch.long)
                mask = _on(device, mask, torch.float32)
            with span("train.mixup", device):
                y_oh = losses.to_one_hot(labels, nc)
                if args.mixup:
                    x, y_oh = losses.mixup(gen, x, y_oh, lam=args.mixup_lambda,
                                           prob=args.mixup_prob)
            with span("train.forward", device):
                with torch.autocast(device.type, dtype=torch.bfloat16,
                                    enabled=cdtype == torch.bfloat16):
                    logits = model(x)
                logits = logits.float()
                if onehot:
                    loss = losses.cross_entropy_one_hot(logits, y_oh, weight=w, sample_mask=mask)
                else:
                    loss = losses.cross_entropy(logits, labels, weight=w, sample_mask=mask)
            with span("train.backward", device):
                grads = torch.autograd.grad(loss, optimizer.params)
            with span("train.optimizer", device):
                optimizer.update(grads, lr)
            return loss.detach()

    return step


def build_eval_step(model: torch.nn.Module, args, mean, std,
                    class_weights: Optional[np.ndarray] = None, device="cuda") -> Callable:
    """Returns ``eval_step(images_u8, labels, mask) -> (loss, logits)``:
    center crop to ``train_resolution`` + ``normalize_only`` + the forward
    in eval mode, in float32 (TF32 off on CUDA), without CLAHE, as the
    JAX eval step. ``mask`` zeroes padded rows."""
    device = torch.device(device)
    w = _class_weights(args, class_weights, device)
    onehot = uses_onehot_loss(args)
    nc = model.num_classes
    in_channels = model.in_channels
    _full_f32(device)

    @torch.no_grad()
    def step(images_u8, labels, mask):
        model.eval()
        x = _center_crop(_on(device, images_u8), args.train_resolution)
        logits = model(normalize_only(x, mean, std, in_channels))
        labels = _on(device, labels, torch.long)
        mask = _on(device, mask, torch.float32)
        if onehot:
            loss = losses.cross_entropy_one_hot(logits, losses.to_one_hot(labels, nc),
                                                weight=w, sample_mask=mask)
        else:
            loss = losses.cross_entropy(logits, labels, weight=w, sample_mask=mask)
        return loss, logits

    return step


def build_predict_step(model: torch.nn.Module, args, mean, std, device,
                       *, apply_clahe: Optional[bool] = None) -> Callable:
    """Returns ``predict(images_u8) -> logits``: (B, R, R, C) uint8 NHWC
    images (numpy or a tensor) in, (B, num_classes) float32 logits on
    ``device`` out.

    The same order as the JAX step: u8 -> f32 / 255 -> CLAHE (clip 1,
    8x8 tiles) when ``args.clahe`` -> ``(x - mean) / std`` -> the model in
    eval mode. All of it runs in float32: on CUDA, TF32 is turned off for
    cuDNN convolutions and matrix products (process-wide), because the
    JAX predict step computes in float32.
    """
    device = torch.device(device)
    use_clahe = args.clahe if apply_clahe is None else apply_clahe
    _full_f32(device)
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device).reshape(1, -1, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device).reshape(1, -1, 1, 1)
    model.eval()

    @torch.inference_mode()
    def predict(images_u8) -> torch.Tensor:
        x = _on(device, images_u8)
        # NHWC -> NCHW view: its strides are channels_last, as the model's
        x = div(x.permute(0, 3, 1, 2).float(), 255.0)
        if use_clahe:
            x = clahe(x, clip_limit=1.0, tiles=8, channels_first=True)
        x = (x - mean_t) / std_t
        return model(x.contiguous(memory_format=torch.channels_last))

    return predict
