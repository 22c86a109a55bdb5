"""Plain image operations of the augmentation chain and the predict step.

A frozen, self-contained copy of the arithmetic the port's pixel pipeline
states (two-pass warps with a 1-D lerp, zero fill; CLAHE on the L channel
of OpenCV's 8-bit LAB; the shift-and-add box blur), in plain PyTorch.
Images are float32 in [0, 1], NCHW. Nothing here is imported from the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as an IEEE quotient on every device (a one-element
    divisor, not a product with the reciprocal)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def pixel_grid(H: int, W: int, device):
    rr = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    cc = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return rr, cc


# ------------------------------------------------------------------ warps

def _tap(planes: torch.Tensor, dim: int, k: torch.Tensor) -> torch.Tensor:
    L = planes.shape[dim]
    valid = (k >= 0) & (k < L)
    v = torch.gather(planes, dim, k.clamp(0, L - 1))
    return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))


def lerp_rows(planes: torch.Tensor, coords: torch.Tensor, axis: int) -> torch.Tensor:
    """(B*C, H, W) planes sampled along ``axis`` (1: rows, 2: columns) at
    the per-image positions ``coords`` (B, H, W) by a 1-D linear
    interpolation, zero outside the plane."""
    C = planes.shape[0] // coords.shape[0]
    q = coords.repeat_interleave(C, dim=0) if C > 1 else coords
    q0 = torch.floor(q)
    k0 = q0.clamp(-2.0, planes.shape[axis] + 1.0).long()
    f = q - q0
    return _tap(planes, axis, k0) * (1.0 - f) + _tap(planes, axis, k0 + 1) * f


def twopass_safe(rotation: float, shear: float, scale: float, min_d: float = 0.35) -> bool:
    """Whether every inverse affine map of these ranges keeps the second
    pass's vertical coefficient above ``min_d``: then the chain's affine
    warp is the two-pass one (else a joint bilinear sample, which no
    configuration here draws)."""
    ang = min(abs(rotation) + abs(shear), 89.0) * math.pi / 180.0
    return math.cos(ang) / (1.0 + abs(scale)) >= min_d


def warp_affine(x: torch.Tensor, mats: torch.Tensor) -> torch.Tensor:
    """Inverse-affine warp of NCHW images about their centre by the two-pass
    shear decomposition: a row pass at q = d xc + e (u - cy) + z + cx, then
    a column pass at p = C xc + D yc + Ty + cy, with e = B / D (D kept
    1e-2 away from 0), d = A - e C, z = Tx - e Ty, (A, B, Tx; C, D, Ty)
    the inverse map."""
    B, C, H, W = x.shape
    planes = x.reshape(B * C, H, W)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    m = mats.float()
    A, Bc, Tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    Cc, D, Ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    lo = torch.full_like(D, 1e-2)
    Ds = torch.where(D.abs() < 1e-2, torch.where(D < 0, -lo, lo), D)
    e = Bc / Ds
    d = A - e * Cc
    z = Tx - e * Ty
    uc = torch.arange(H, dtype=torch.float32, device=x.device) - cy
    xc = torch.arange(W, dtype=torch.float32, device=x.device) - cx
    q = d[:, None, None] * xc[None, None, :] + e[:, None, None] * uc[None, :, None] \
        + z[:, None, None] + cx
    p = Cc[:, None, None] * xc[None, None, :] + D[:, None, None] * uc[None, :, None] \
        + Ty[:, None, None] + cy
    return lerp_rows(lerp_rows(planes, q, 2), p, 1).reshape(B, C, H, W)


def warp_dense(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """The two-pass displacement warp: a vertical pass at (r + dy, c),
    then a horizontal one at (r, c + dx)."""
    B, C, H, W = x.shape
    rr, cc = pixel_grid(H, W, x.device)
    tmp = lerp_rows(x.reshape(B * C, H, W), rr[None] + dy, 1)
    return lerp_rows(tmp, cc[None] + dx, 2).reshape(B, C, H, W)


def box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """Zero-padded k x k box blur of NCHW images: the row shifts summed in
    order, then the column shifts, then one division."""
    H, W = x.shape[2], x.shape[3]
    pad = k // 2
    z = F.pad(x, (pad, pad, pad, pad))
    rows = z.narrow(2, 0, H)
    for i in range(1, k):
        rows = rows + z.narrow(2, i, H)
    out = rows.narrow(3, 0, W)
    for j in range(1, k):
        out = out + rows.narrow(3, j, W)
    return div(out, float(k * k))


# ------------------------------------------------------------------ CLAHE

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]], np.float64)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ)
_XN, _ZN = 0.950456, 1.088754
_EPS, _KAPPA = 0.008856, 903.3


def _rgb_to_lab_u8(x: torch.Tensor) -> torch.Tensor:
    """NCHW RGB in [0, 1] -> LAB on OpenCV's 8-bit scale (float32)."""
    rgb = torch.floor((x.float() * 255.0 + 0.5).clamp(0, 255))
    rgb = div(rgb, 255.0)
    rgb = torch.where(rgb <= 0.04045, div(rgb, 12.92), torch.pow(div(rgb + 0.055, 1.055), 2.4))
    r, g, b = rgb[:, 0], rgb[:, 1], rgb[:, 2]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = _RGB2XYZ.tolist()
    xr = div(m00 * r + m01 * g + m02 * b, _XN)
    yr = m10 * r + m11 * g + m12 * b
    zr = div(m20 * r + m21 * g + m22 * b, _ZN)

    def f(t):
        return torch.where(t > _EPS, torch.pow(t.clamp(min=0.0), 1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xr), f(yr), f(zr)
    L = torch.where(yr > _EPS, 116.0 * fy - 16.0, _KAPPA * yr)
    lab = torch.stack([L * (255.0 / 100.0), 500.0 * (fx - fy) + 128.0,
                       200.0 * (fy - fz) + 128.0], dim=1)
    return lab.clamp(0.0, 255.0)


def _lab_u8_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    L = lab[:, 0] * (100.0 / 255.0)
    a, b = lab[:, 1] - 128.0, lab[:, 2] - 128.0
    fy = div(L + 16.0, 116.0)
    fx, fz = fy + div(a, 500.0), fy - div(b, 200.0)

    def finv(t):
        t3 = t * t * t
        return torch.where(t3 > _EPS, t3, div(t - 16.0 / 116.0, 7.787))

    yr = torch.where(L > _KAPPA * _EPS, fy * fy * fy, div(L, _KAPPA))
    x_, y_, z_ = finv(fx) * _XN, yr, finv(fz) * _ZN
    (i00, i01, i02), (i10, i11, i12), (i20, i21, i22) = _XYZ2RGB.tolist()
    rgb = torch.stack([i00 * x_ + i01 * y_ + i02 * z_, i10 * x_ + i11 * y_ + i12 * z_,
                       i20 * x_ + i21 * y_ + i22 * z_], dim=1).clamp(0.0, 1.0)
    rgb = torch.where(rgb <= 0.0031308, 12.92 * rgb,
                      1.055 * torch.pow(rgb.clamp(min=0.0), 1.0 / 2.4) - 0.055).clamp(0.0, 1.0)
    return div(torch.floor(rgb * 255.0 + 0.5), 255.0)


def _clahe_planes(u8: torch.Tensor, clip: float, T: int) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) float32 in [0, 1]: clipped tile
    histograms (the excess spread evenly), their CDF LUTs, each pixel
    mixing its four neighbouring tiles' LUTs bilinearly, / 255."""
    N, H, W = u8.shape
    th, tw = -(-H // T), -(-W // T)
    P = th * tw
    dev = u8.device
    rows = torch.arange(T * th, device=dev).clamp(max=H - 1)
    cols = torch.arange(T * tw, device=dev).clamp(max=W - 1)
    t = u8[:, rows][:, :, cols].reshape(N, T, th, T, tw).permute(0, 1, 3, 2, 4)
    t = t.reshape(N, T * T, P).long()
    hist = torch.zeros((N, T * T, 256), dtype=torch.float32, device=dev)
    hist.scatter_add_(2, t, torch.ones(t.shape, dtype=torch.float32, device=dev))
    limit = max(clip * P / 256.0, 1.0)
    excess = (hist - limit).clamp(min=0.0).sum(-1, keepdim=True)
    cdf = torch.cumsum(hist.clamp(max=limit) + div(excess, 256.0), dim=-1)
    luts = torch.round(div(cdf, P) * 255.0).clamp(0.0, 255.0).reshape(N, T * T * 256)

    def axis(n, s):
        f = div(torch.arange(n, dtype=torch.float32, device=dev) - s / 2.0, s)
        i0 = f.floor().clamp(0, T - 1).long()
        return i0, (i0 + 1).clamp(max=T - 1), (f - i0).clamp(0.0, 1.0)

    y0, y1, wy = axis(H, th)
    x0, x1, wx = axis(W, tw)
    v = u8.long().reshape(N, H * W)

    def lut(ty, tx):
        base = ((ty[:, None] * T + tx[None, :]) * 256).reshape(1, H * W)
        return torch.gather(luts, 1, base + v).reshape(N, H, W)

    wx, wy = wx.reshape(1, 1, W), wy.reshape(1, H, 1)
    top = lut(y0, x0) * (1 - wx) + lut(y0, x1) * wx
    bot = lut(y1, x0) * (1 - wx) + lut(y1, x1) * wx
    return div(top * (1 - wy) + bot * wy, 255.0)


def _clahe_channels(x: torch.Tensor, clip: float, T: int) -> torch.Tensor:
    B, C, H, W = x.shape
    u8 = (x * 255.0 + 0.5).clamp(0, 255).to(torch.uint8).reshape(B * C, H, W)
    return _clahe_planes(u8, clip, T).reshape(B, C, H, W)


def clahe(x: torch.Tensor, clip: float = 1.0, tiles: int = 8) -> torch.Tensor:
    """CLAHE of NCHW images in [0, 1]: a 3-channel image is equalised on
    the L channel of 8-bit LAB, other channel counts channel by channel."""
    if x.shape[1] != 3:
        return _clahe_channels(x, clip, tiles)
    lab = torch.round(_rgb_to_lab_u8(x)).to(torch.uint8)
    L = _clahe_channels(div(lab[:, :1].float(), 255.0), clip, tiles)
    L = torch.round(L * 255.0).to(torch.uint8)
    return _lab_u8_to_rgb(torch.cat([L, lab[:, 1:]], dim=1).float())
