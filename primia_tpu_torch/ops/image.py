"""Image ops of the serving path: CLAHE and the RGB <-> LAB conversions.

Port of the CLAHE part of ``primia_tpu/ops/image.py`` (``clahe``,
``_clahe_channels``, ``rgb_to_lab_u8``, ``lab_u8_to_rgb``). Images are
float32 in [0, 1], NHWC or, with ``channels_first``, NCHW. The per-tile
LUTs and their bilinear apply are the two kernels of
``ops/cuda_clahe.py``: CUDA tensors go to the kernels, CPU tensors to
their plain versions. The LAB conversions are elementwise PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from primia_tpu_torch.ops.cuda_clahe import clahe_apply, clahe_luts, div

# OpenCV D65 colour matrices (cvtColor docs), as in the JAX package:
# linear RGB in [0, 1] -> XYZ; the white point Xn/Zn normalisation is
# folded in at the use site.
_RGB2XYZ = np.array(
    [[0.412453, 0.357580, 0.180423],
     [0.212671, 0.715160, 0.072169],
     [0.019334, 0.119193, 0.950227]], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_XN = 0.950456
_ZN = 1.088754
_LAB_EPS = 0.008856  # (6/29)^3
_LAB_KAPPA = 903.3   # 29^3/3^3 (OpenCV's value)


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB companding removal (IEC 61966-2-1), as cv2's 8-bit
    COLOR_RGB2LAB applies it."""
    return torch.where(x <= 0.04045, div(x, 12.92),
                       torch.pow(div(x + 0.055, 1.055), 2.4))


def _linear_to_srgb(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y <= 0.0031308, 12.92 * y,
                       1.055 * torch.pow(y.clamp(min=0.0), 1.0 / 2.4) - 0.055)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    # PyTorch has no cbrt; only positive inputs (t > _LAB_EPS) reach here
    return torch.pow(t.clamp(min=0.0), 1.0 / 3.0)


def rgb_to_lab_u8(imgs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """RGB floats in [0, 1] (channel ``axis``, size 3) -> LAB in
    OpenCV's uint8 scale (L in [0, 255] = L*255/100, a and b offset by
    +128), kept in float32."""
    rgb = torch.floor((imgs.float() * 255.0 + 0.5).clamp(0, 255))
    rgb = _srgb_to_linear(div(rgb, 255.0))
    r, g, b_ = (rgb.select(axis, i) for i in range(3))
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = _RGB2XYZ.tolist()
    xr = div(m00 * r + m01 * g + m02 * b_, _XN)
    yr = m10 * r + m11 * g + m12 * b_
    zr = div(m20 * r + m21 * g + m22 * b_, _ZN)

    def f(t):
        return torch.where(t > _LAB_EPS, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xr), f(yr), f(zr)
    L = torch.where(yr > _LAB_EPS, 116.0 * fy - 16.0, _LAB_KAPPA * yr)
    a = 500.0 * (fx - fy) + 128.0
    b = 200.0 * (fy - fz) + 128.0
    lab = torch.stack([L * (255.0 / 100.0), a, b], dim=axis)
    return lab.clamp(0.0, 255.0)


def lab_u8_to_rgb(lab: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`rgb_to_lab_u8`; returns [0, 1] floats quantized
    to uint8 levels."""
    L = lab.select(axis, 0) * (100.0 / 255.0)
    a = lab.select(axis, 1) - 128.0
    b = lab.select(axis, 2) - 128.0
    fy = div(L + 16.0, 116.0)
    fx = fy + div(a, 500.0)
    fz = fy - div(b, 200.0)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > _LAB_EPS, t3, div(t - 16.0 / 116.0, 7.787))

    yr = torch.where(L > _LAB_KAPPA * _LAB_EPS, fy * fy * fy, div(L, _LAB_KAPPA))
    x_, y_, z_ = finv(fx) * _XN, yr, finv(fz) * _ZN
    (i00, i01, i02), (i10, i11, i12), (i20, i21, i22) = _XYZ2RGB.tolist()
    rgb = torch.stack(
        [i00 * x_ + i01 * y_ + i02 * z_,
         i10 * x_ + i11 * y_ + i12 * z_,
         i20 * x_ + i21 * y_ + i22 * z_], dim=axis)
    rgb = _linear_to_srgb(rgb.clamp(0.0, 1.0)).clamp(0.0, 1.0)
    return div(torch.floor(rgb * 255.0 + 0.5), 255.0)


def clahe(imgs: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8,
          channels_first: bool = False) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation (batched).

    albumentations' ``CLAHE`` channel semantics, as in the JAX package: a
    3-channel image goes RGB -> LAB (OpenCV uint8 convention) and only
    its L channel is equalised; other channel counts are equalised
    channel by channel.
    """
    ch_ax = 1 if channels_first else -1
    if imgs.shape[ch_ax] == 3:
        lab = torch.round(rgb_to_lab_u8(imgs, axis=ch_ax)).to(torch.uint8)
        L = lab.narrow(ch_ax, 0, 1)
        L_eq = _clahe_channels(div(L.float(), 255.0), clip_limit, tiles,
                               channels_first=channels_first)
        L_u8 = torch.round(L_eq.float() * 255.0).to(torch.uint8)
        lab = torch.cat([L_u8, lab.narrow(ch_ax, 1, 2)], dim=ch_ax)
        return lab_u8_to_rgb(lab.float(), axis=ch_ax).to(imgs.dtype)
    return _clahe_channels(imgs, clip_limit, tiles, channels_first=channels_first)


def _clahe_channels(imgs: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8,
                    channels_first: bool = False) -> torch.Tensor:
    """Per-channel CLAHE on [0, 1] floats: quantize to uint8 planes, per
    tile LUTs (kernel 1), bilinear LUT apply (kernel 2), back to [0, 1].

    Reference: the gather path of ``primia_tpu/ops/image.py:
    _clahe_channels``, which the JAX predict step runs off the TPU.
    """
    x = imgs if channels_first else imgs.permute(0, 3, 1, 2)
    B, C, H, W = x.shape
    u8 = (x * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    planes = u8.reshape(B * C, H, W).contiguous()
    luts = clahe_luts(planes, clip_limit, tiles)
    out = div(clahe_apply(planes, luts, tiles).reshape(B, C, H, W), 255.0)
    if not channels_first:
        out = out.permute(0, 2, 3, 1)
    return out.to(imgs.dtype)
