"""Batched image ops: bilinear warps, CLAHE, the RGB <-> LAB conversions,
blur, histogram equalisation and resize.

Port of ``primia_tpu/ops/image.py``. Images are float32 in [0, 1], NHWC
or, with ``channels_first``, NCHW; warps use inverse mapping with zero
fill. The kernels sit behind two modules: the warps' resamplers in
``ops/cuda_tent.py`` (K1, the 1-D lerp of the two-pass warps; K2, the
bilinear gather) and CLAHE in ``ops/cuda_clahe.py`` (K3 on uint8 planes:
LUTs, apply, / 255; and the 3-channel CLAHE with its RGB -> LAB -> RGB
as one kernel).
CUDA tensors go to the kernels, CPU tensors to their plain versions, so
both devices compute the TPU's default semantics:

- ``warp_affine(twopass=True)`` is the shear decomposition on K1, which
  the caller picks when ``twopass_safe`` holds for its draw ranges;
  ``twopass=False`` is K2.
- ``warp_dense`` is the two-pass displacement warp on K1, or K2 under
  ``PRIMIA_WARP_TWOPASS=0``; that switch changes the math, so it is
  honoured.
- The TPU-implementation switches of the JAX package
  (``PRIMIA_PALLAS_WARP``, ``PRIMIA_TWOPASS_WARP``,
  ``PRIMIA_PALLAS_AUGMENT``) choose among TPU formulations of the same
  math and pick nothing here. ``PRIMIA_PALLAS_AUGMENT`` sends the JAX
  package's ``warp_affine(twopass=False)`` to its K6
  (``pallas_kernels.py:resample_bilinear_pallas``, bilinear with zero
  fill); that contract already is this ``warp_affine(twopass=False)``
  on K2.

Everything else is elementwise PyTorch.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from primia_tpu_torch.ops.cuda_clahe import clahe_channels, clahe_rgb
# the JAX package's image module holds the LAB conversions; here they live
# beside the kernel that computes them
from primia_tpu_torch.ops.cuda_clahe import lab_u8_to_rgb, rgb_to_lab_u8  # noqa: F401
from primia_tpu_torch.ops.cuda_tent import tent_bilinear, tent_rows
from primia_tpu_torch.ops.numerics import div


# ----------------------------------------------------------------- sampling

def _to_planes(imgs: torch.Tensor, channels_first: bool) -> Tuple[torch.Tensor, int, int]:
    """(B, H, W, C) or (B, C, H, W) -> contiguous float32 (B*C, H, W)."""
    x = imgs if channels_first else imgs.permute(0, 3, 1, 2)
    B, C, H, W = x.shape
    return x.float().contiguous().reshape(B * C, H, W), B, C


def _from_planes(planes: torch.Tensor, B: int, C: int, channels_first: bool,
                 dtype: torch.dtype) -> torch.Tensor:
    x = planes.reshape(B, C, *planes.shape[1:])
    return (x if channels_first else x.permute(0, 2, 3, 1)).to(dtype)


def pixel_grid(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row, column) index grids, float32 (H, W)."""
    rr = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    cc = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return rr, cc


def bilinear_sample(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Sample one HWC image at float coordinates (ys, xs) of shape
    (H', W'); out-of-bounds taps read 0. K2 on CUDA."""
    planes = img.permute(2, 0, 1).float().contiguous()
    out = tent_bilinear(planes, ys.float()[None], xs.float()[None])
    return out.permute(1, 2, 0).to(img.dtype)


def affine_row_band(rotation_deg: float, shear_deg: float, scale_frac: float,
                    width: int, chunk_rows: int = 16) -> int:
    """Static source-row-band bound of the JAX package's banded resampler
    under the augment config's inverse-affine ranges (kept for its
    callers; a gather needs no band).

    Within a chunk of ``chunk_rows`` output rows, sy = ic*xc + id*yc + ty
    varies by at most |ic|*(W-1) + |id|*(chunk_rows-1), with
    |ic| <= sin(rot+|shear|)/s_min and |id| <= 1/s_min over the draw
    ranges; +3 covers the bilinear support and the floor of the base row.
    """
    s_min = 1.0 - abs(scale_frac)
    if s_min < 0.1:
        # the drawn scale can get arbitrarily close to 0: no finite band
        return 1 << 30
    ang = min(abs(rotation_deg) + abs(shear_deg), 89.0) * math.pi / 180.0
    spread = math.sin(ang) / s_min * (width - 1) + (chunk_rows - 1) / s_min
    return int(math.ceil(spread)) + 3


def twopass_safe(rotation_deg: float, shear_deg: float, scale_frac: float,
                 min_d: float = 0.35) -> bool:
    """Static check that the two-pass decomposition is well-conditioned
    for every matrix the augment config can draw: the pass-2 vertical
    coefficient |D| >= cos(rot + |shear|) / (1 + scale) stays above
    ``min_d``, which bounds the shear pass's magnification 1/|D|."""
    ang = min(abs(rotation_deg) + abs(shear_deg), 89.0) * math.pi / 180.0
    return math.cos(ang) / (1.0 + abs(scale_frac)) >= min_d


def twopass_coords(mats: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two-pass affine warp's source positions, each (B, H, W) on
    ``mats``' device: ``q`` (pass 1, a column of the same row) and ``p``
    (pass 2, a row of the same column); see :func:`warp_affine_twopass`."""
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    m = mats.float()
    A_, Bc = m[:, 0, 0], m[:, 0, 1]
    Cc, D_ = m[:, 1, 0], m[:, 1, 1]
    Tx, Ty = m[:, 0, 2], m[:, 1, 2]
    lo = torch.full_like(D_, 1e-2)
    Dsafe = torch.where(D_.abs() < 1e-2, torch.where(D_ < 0, -lo, lo), D_)
    e = Bc / Dsafe
    d = A_ - e * Cc
    z = Tx - e * Ty
    uc = torch.arange(H, dtype=torch.float32, device=m.device) - cy
    xc = torch.arange(W, dtype=torch.float32, device=m.device) - cx
    q = (d[:, None, None] * xc[None, None, :] + e[:, None, None] * uc[None, :, None]
         + z[:, None, None] + cx)
    p = (Cc[:, None, None] * xc[None, None, :] + D_[:, None, None] * uc[None, :, None]
         + Ty[:, None, None] + cy)
    return q, p


def affine_coords(mats: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute source positions (sy, sx), each (B, H, W), of the inverse
    affine maps ``mats`` for an H x W output, centred on the image."""
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    m = mats.float()
    rr, cc = pixel_grid(H, W, m.device)
    ys, xs = rr - cy, cc - cx
    sy = (m[:, 1, 0, None, None] * xs + m[:, 1, 1, None, None] * ys
          + m[:, 1, 2, None, None] + cy)
    sx = (m[:, 0, 0, None, None] * xs + m[:, 0, 1, None, None] * ys
          + m[:, 0, 2, None, None] + cx)
    return sy, sx


def warp_affine_twopass(imgs: torch.Tensor, mats: torch.Tensor,
                        channels_first: bool = False) -> torch.Tensor:
    """Affine warp as two axis-aligned shear/scale passes (Catmull-Smith),
    ``primia_tpu/ops/image.py:warp_affine_twopass``:

        pass 1:  tmp[u, x] = img[u, q(u, x)]   q = d*xc + e*(u-cy) + z + cx
        pass 2:  out[y, x] = tmp[p(y, x), x]   p = C*xc + D*yc + Ty + cy

    with e = B/D (D clamped away from 0 by 1e-2), d = A - e*C,
    z = Tx - e*Ty, (A, B, Tx; C, D, Ty) the inverse map. Pass 2's lerp
    reads pass 1 at the two integer rows around p, so the horizontal
    position differs from a true 2-D bilinear by at most |B| pixels.
    Callers check ``twopass_safe`` first. Each pass is one K1 launch on
    CUDA (row form, then column form).
    """
    mats = mats.to(imgs.device)
    x, B, C = _to_planes(imgs, channels_first)
    q, p = twopass_coords(mats, *x.shape[1:])
    out = tent_rows(tent_rows(x, q, axis=2), p, axis=1)
    return _from_planes(out, B, C, channels_first, imgs.dtype)


def warp_affine(imgs: torch.Tensor, mats: torch.Tensor, twopass: bool = False,
                row_band: Optional[int] = None, channels_first: bool = False) -> torch.Tensor:
    """Batched inverse-affine warp. ``mats`` (B, 2, 3) maps OUTPUT pixel
    coordinates (x, y, 1), centred on the image centre, to input
    coordinates (torchvision RandomAffine convention).

    ``twopass``: the shear decomposition (:func:`warp_affine_twopass`,
    K1); pass True only when ``twopass_safe`` holds for the matrix
    ranges. Otherwise the exact bilinear gather (K2). ``row_band`` was the
    JAX package's static band for its tent contraction; a gather needs
    none, so it is accepted and ignored.
    """
    if twopass:
        return warp_affine_twopass(imgs, mats, channels_first=channels_first)
    mats = mats.to(imgs.device)
    x, B, C = _to_planes(imgs, channels_first)
    sy, sx = affine_coords(mats, *x.shape[1:])
    return _from_planes(tent_bilinear(x, sy, sx), B, C, channels_first, imgs.dtype)


def warp_dense(imgs: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor,
               max_dy: Optional[float] = None, channels_first: bool = False) -> torch.Tensor:
    """Batched dense warp: sample the input near (y + dy, x + dx).

    dy, dx: (B, H, W) displacement fields in pixels. By default the
    two-pass form of the TPU's augmentation warp
    (``pallas_tent.py:warp_dense_twopass_pallas``): a vertical pass, then
    a horizontal one,

        out[r, j] = img[r + dy(r, x*), x*],   x* = j + dx(r, j),

    which samples the vertical field at the pre-warp column: exact for
    axis-aligned or locally constant fields, a same-class smooth
    distortion otherwise (an augmentation warp, not a general resampler).
    Two K1 launches on CUDA. ``PRIMIA_WARP_TWOPASS=0`` takes the exact
    joint bilinear sample at (y + dy, x + dx) instead, one K2 launch;
    ``max_dy`` is K2's moot band bound.
    """
    x, B, C = _to_planes(imgs, channels_first)
    H, W = x.shape[1:]
    rr, cc = pixel_grid(H, W, x.device)
    dy = dy.to(device=x.device, dtype=torch.float32)
    dx = dx.to(device=x.device, dtype=torch.float32)
    if os.environ.get("PRIMIA_WARP_TWOPASS", "1") != "0":
        tmp = tent_rows(x, rr[None] + dy, axis=1)
        out = tent_rows(tmp, cc[None] + dx, axis=2)
    else:
        out = tent_bilinear(x, rr[None] + dy, cc[None] + dx, max_dy=max_dy)
    return _from_planes(out, B, C, channels_first, imgs.dtype)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(method="bilinear")``
    along one axis: the triangle kernel, widened by the scale when
    downsampling (antialias), normalised per output sample, computed in
    float64 as JAX computes them for Python-float scales."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample_f = (np.arange(n_out, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float64)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, 0)


def resize_bilinear(imgs: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with ``jax.image.resize`` semantics
    (half-pixel centres, antialiased when downsampling)."""
    B, H, W, C = imgs.shape
    wh = torch.as_tensor(_resize_weights(H, size[0]), dtype=imgs.dtype, device=imgs.device)
    ww = torch.as_tensor(_resize_weights(W, size[1]), dtype=imgs.dtype, device=imgs.device)
    return torch.einsum("bhwc,hy,wx->byxc", imgs, wh, ww)


# -------------------------------------------------------------- histograms

def equalize(imgs: torch.Tensor, channels_first: bool = False) -> torch.Tensor:
    """Global histogram equalisation per image and channel ([0, 1] floats):
    the 256-bin histogram's CDF, rebased at its first occupied bin,
    stretched to [0, 255] and rounded."""
    u8 = (imgs * 255.0 + 0.5).clamp(0, 255).long()
    x = u8 if channels_first else u8.permute(0, 3, 1, 2)
    B, C, H, W = x.shape
    flat = x.reshape(B * C, H * W)
    hist = torch.zeros((B * C, 256), dtype=torch.float32, device=imgs.device)
    hist.scatter_add_(1, flat, torch.ones(flat.shape, dtype=torch.float32, device=imgs.device))
    cdf = torch.cumsum(hist, dim=1)
    total = cdf[:, -1:]
    cdf_min = cdf.gather(1, (hist > 0).float().argmax(dim=1, keepdim=True))
    lut = torch.round((cdf - cdf_min) / torch.clamp(total - cdf_min, min=1.0) * 255.0)
    out = lut.clamp(0, 255).gather(1, flat).reshape(B, C, H, W)
    if not channels_first:
        out = out.permute(0, 2, 3, 1)
    return div(out.to(imgs.dtype), 255.0)

def clahe(imgs: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8,
          channels_first: bool = False) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalisation (batched).

    albumentations' ``CLAHE`` channel semantics, as in the JAX package: a
    3-channel image goes RGB -> LAB (OpenCV uint8 convention) and only
    its L channel is equalised (``cuda_clahe.clahe_rgb``: one kernel on the
    card); other channel counts are equalised channel by channel
    (``cuda_clahe.clahe_channels``).
    """
    if imgs.shape[1 if channels_first else -1] != 3:
        return clahe_channels(imgs, clip_limit, tiles, channels_first=channels_first)
    x = imgs if channels_first else imgs.permute(0, 3, 1, 2)
    out = clahe_rgb(x.float(), clip_limit, tiles)
    return (out if channels_first else out.permute(0, 2, 3, 1)).to(imgs.dtype)


# ------------------------------------------------------------------ blur

def box_blur(imgs: torch.Tensor, ksize: int, channels_first: bool = False) -> torch.Tensor:
    """Depthwise box blur, zero-padded, same-size output, as the JAX
    package's shift-and-add: the ``ksize`` row shifts summed in order,
    then the column shifts, then one division."""
    ha, wa = (2, 3) if channels_first else (1, 2)
    H, W = imgs.shape[ha], imgs.shape[wa]
    pad = ksize // 2
    z = F.pad(imgs, (pad, pad, pad, pad) if channels_first else (0, 0, pad, pad, pad, pad))
    rows = z.narrow(ha, 0, H)
    for i in range(1, ksize):
        rows = rows + z.narrow(ha, i, H)
    out = rows.narrow(wa, 0, W)
    for j in range(1, ksize):
        out = out + rows.narrow(wa, j, W)
    return div(out, float(ksize * ksize))
