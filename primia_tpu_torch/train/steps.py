"""The predict step of the inference and evaluate CLIs.

Port of ``primia_tpu/train/steps.py:build_predict_step``. The train and
eval steps come with the training slice (ROADMAP).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from primia_tpu_torch.ops.cuda_clahe import div
from primia_tpu_torch.ops.image import clahe


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
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device).reshape(1, -1, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device).reshape(1, -1, 1, 1)
    model.eval()

    @torch.inference_mode()
    def predict(images_u8) -> torch.Tensor:
        if not isinstance(images_u8, torch.Tensor):
            # a copy: a cached dataset is a read-only memory map
            images_u8 = torch.from_numpy(np.array(images_u8, np.uint8))
        x = images_u8.to(device)
        # NHWC -> NCHW view: its strides are channels_last, as the model's
        x = div(x.permute(0, 3, 1, 2).float(), 255.0)
        if use_clahe:
            x = clahe(x, clip_limit=1.0, tiles=8, channels_first=True)
        x = (x - mean_t) / std_t
        return model(x.contiguous(memory_format=torch.channels_last))

    return predict
