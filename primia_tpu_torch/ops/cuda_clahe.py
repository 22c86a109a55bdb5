"""CLAHE as hand-written kernels, from uint8 planes or from RGB images.

Port of ``primia_tpu/ops/pallas_clahe.py`` (its two ``pallas_call``s and
the ``/ 255.0`` after them) and of the 3-channel CLAHE around them
(``primia_tpu/ops/image.py:clahe``: RGB -> 8-bit LAB, CLAHE of L, back).
The CUDA kernels live in ``primia_tpu_torch/csrc/clahe.cu`` (its header
note says what each replaces, what bounds it and how it is laid out):

- ``clahe_planes`` (K3, ``clahe_kernel``): per-tile LUTs, their bilinear
  apply and the division by 255, from (N, H, W) uint8 planes to [0, 1]
  floats. Its plain version follows the JAX package's gather path
  (``primia_tpu/ops/image.py:_clahe_channels``) in two stages, the LUTs
  and their apply.
- ``clahe_rgb`` (``clahe_lab_kernel``): the whole 3-channel CLAHE of
  (B, 3, H, W) float32 images in one launch. Its plain version,
  ``clahe_rgb_plain``, is the composition of the LAB conversions below
  with ``clahe_channels`` on L.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel (counted in ``_build.launches``) or raises.

Tile geometry: ``T = tiles`` tiles a side, each ``th = ceil(H/T)`` by
``tw = ceil(W/T)`` pixels; the last tile row and column are filled with
the image's edge pixels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from primia_tpu_torch.ops._build import declare, launch, load_library, on_card
from primia_tpu_torch.ops.numerics import div

_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_i64s = ctypes.POINTER(ctypes.c_longlong)
declare("clahe", {"clahe": [_vp, _vp, _vp, _ci, _ci, _ci, _ci, _ci, _ci, _cf],
                  "clahe_lab": [_vp, _vp, _vp, ctypes.POINTER(_cf), _i64s, _i64s, _ci, _ci, _ci,
                                _ci, _ci, _ci, _cf]},
        queries={"clahe_lab_consts": [], "clahe_smem_bytes": [_ci] * 5,
                 "clahe_max_active_clusters": [_ci] * 5})

MAX_TILES = 8  # the kernel runs a cluster of T CTAs a plane; 8 is the portable limit
MAX_SMEM_BYTES = 232_448  # the dynamic shared memory an H100 CTA can use (227 KB)


def tile_geometry(H: int, W: int, tiles: int) -> Tuple[int, int]:
    return -(-H // tiles), -(-W // tiles)


def clip_limit_count(clip_limit: float, th: int, tw: int) -> float:
    """Histogram clip height in pixels (OpenCV: clip * mean bin count,
    at least 1)."""
    return max(clip_limit * (th * tw) / 256.0, 1.0)


def _check_planes(planes: torch.Tensor) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 3:
        raise ValueError(
            f"expected (N, H, W) uint8 planes, got {tuple(planes.shape)} {planes.dtype}")


def _check_luts(luts: torch.Tensor, N: int, tiles: int, device) -> None:
    want = (N, tiles * tiles, 256)
    if tuple(luts.shape) != want or luts.dtype != torch.float32:
        raise ValueError(f"expected {want} float32 LUTs, got "
                         f"{tuple(luts.shape)} {luts.dtype}")
    if luts.device != device:
        raise ValueError(f"LUTs on {luts.device}, planes on {device}")


# ---------------------------------------------------- the plain version

def clahe_luts_plain(planes: torch.Tensor, clip_limit: float = 1.0,
                     tiles: int = 8) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, T*T, 256) float32 LUTs with integer values,
    tile-major (row ``ty * T + tx``)."""
    _check_planes(planes)
    N, H, W = planes.shape
    T = tiles
    th, tw = tile_geometry(H, W, T)
    P = th * tw
    dev = planes.device
    rows = torch.arange(T * th, device=dev).clamp_(max=H - 1)
    cols = torch.arange(T * tw, device=dev).clamp_(max=W - 1)
    x = planes[:, rows][:, :, cols]  # edge padding by clamped indices
    x = x.reshape(N, T, th, T, tw).permute(0, 1, 3, 2, 4).reshape(N, T * T, P)
    hist = torch.zeros((N, T * T, 256), dtype=torch.float32, device=dev)
    hist.scatter_add_(2, x.long(), torch.ones(x.shape, dtype=torch.float32, device=dev))
    limit = clip_limit_count(clip_limit, th, tw)
    excess = (hist - limit).clamp_(min=0.0).sum(-1, keepdim=True)
    cdf = torch.cumsum(hist.clamp_(max=limit) + div(excess, 256.0), dim=-1)
    return torch.round(div(cdf, P) * 255.0).clamp_(0.0, 255.0)


def clahe_apply_plain(planes: torch.Tensor, luts: torch.Tensor,
                      tiles: int = 8) -> torch.Tensor:
    """(N, H, W) uint8 + (N, T*T, 256) LUTs -> (N, H, W) float32 in
    [0, 255]: each pixel mixes its four neighbouring tiles' LUT values
    bilinearly on the half-tile-shifted grid, edges clamped."""
    _check_planes(planes)
    N, H, W = planes.shape
    T = tiles
    _check_luts(luts, N, T, planes.device)
    th, tw = tile_geometry(H, W, T)
    dev = planes.device

    def axis(n, t):
        f = div(torch.arange(n, dtype=torch.float32, device=dev) - t / 2.0, t)
        i0 = f.floor().clamp_(0, T - 1).long()
        i1 = (i0 + 1).clamp_(max=T - 1)
        return i0, i1, (f - i0).clamp_(0.0, 1.0)

    y0, y1, wy = axis(H, th)
    x0, x1, wx = axis(W, tw)
    flat = luts.reshape(N, T * T * 256)
    v = planes.long().reshape(N, H * W)

    def lut_at(ty, tx):
        base = ((ty[:, None] * T + tx[None, :]) * 256).reshape(1, H * W)
        return torch.gather(flat, 1, base + v).reshape(N, H, W)

    wx = wx.reshape(1, 1, W)
    wy = wy.reshape(1, H, 1)
    top = lut_at(y0, x0) * (1 - wx) + lut_at(y0, x1) * wx
    bot = lut_at(y1, x0) * (1 - wx) + lut_at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def clahe_planes_plain(planes: torch.Tensor, clip_limit: float = 1.0,
                       tiles: int = 8) -> torch.Tensor:
    """(N, H, W) uint8 -> (N, H, W) float32 in [0, 1]: the LUTs, their
    apply, then the IEEE quotient by 255."""
    luts = clahe_luts_plain(planes, clip_limit, tiles)
    return div(clahe_apply_plain(planes, luts, tiles), 255.0)


def clahe_channels(imgs: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8,
                   channels_first: bool = False) -> torch.Tensor:
    """Per-channel CLAHE of (B, H, W, C) or, with ``channels_first``,
    (B, C, H, W) images in [0, 1]: quantize to uint8 planes, then
    :func:`clahe_planes`.

    Reference: the gather path of ``primia_tpu/ops/image.py:
    _clahe_channels``, which the JAX predict step runs off the TPU.
    """
    x = imgs if channels_first else imgs.permute(0, 3, 1, 2)
    B, C, H, W = x.shape
    u8 = (x * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    planes = u8.reshape(B * C, H, W).contiguous()
    out = clahe_planes(planes, clip_limit, tiles).reshape(B, C, H, W)
    if not channels_first:
        out = out.permute(0, 2, 3, 1)
    return out.to(imgs.dtype)


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
_LAB_SLOPE = 7.787   # f's linear segment: slope t + 16/116
_LAB_OFFSET = 16.0 / 116.0
# IEC 61966-2-1 sRGB companding: s = 1.055 y^(1/2.4) - 0.055 above the
# knee, 12.92 y below
_SRGB_KNEE = 0.0031308
_SRGB_SLOPE = 12.92
_SRGB_GAMMA = 2.4
_SRGB_SCALE = 1.055
_SRGB_OFFSET = 0.055


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    """sRGB companding removal (IEC 61966-2-1), as cv2's 8-bit
    COLOR_RGB2LAB applies it."""
    return torch.where(x <= 0.04045, div(x, _SRGB_SLOPE),
                       torch.pow(div(x + _SRGB_OFFSET, _SRGB_SCALE), _SRGB_GAMMA))


def _linear_to_srgb(y: torch.Tensor) -> torch.Tensor:
    return torch.where(y <= _SRGB_KNEE, _SRGB_SLOPE * y,
                       _SRGB_SCALE * torch.pow(y.clamp(min=0.0), 1.0 / _SRGB_GAMMA)
                       - _SRGB_OFFSET)


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
        return torch.where(t > _LAB_EPS, _cbrt(t), _LAB_SLOPE * t + _LAB_OFFSET)

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
        return torch.where(t3 > _LAB_EPS, t3, div(t - _LAB_OFFSET, _LAB_SLOPE))

    yr = torch.where(L > _LAB_KAPPA * _LAB_EPS, fy * fy * fy, div(L, _LAB_KAPPA))
    x_, y_, z_ = finv(fx) * _XN, yr, finv(fz) * _ZN
    (i00, i01, i02), (i10, i11, i12), (i20, i21, i22) = _XYZ2RGB.tolist()
    rgb = torch.stack(
        [i00 * x_ + i01 * y_ + i02 * z_,
         i10 * x_ + i11 * y_ + i12 * z_,
         i20 * x_ + i21 * y_ + i22 * z_], dim=axis)
    rgb = _linear_to_srgb(rgb.clamp(0.0, 1.0)).clamp(0.0, 1.0)
    return div(torch.floor(rgb * 255.0 + 0.5), 255.0)


def clahe_rgb_plain(x: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8) -> torch.Tensor:
    """:func:`clahe_rgb`'s plain version: (B, 3, H, W) float RGB -> LAB in
    uint8, :func:`clahe_channels` on L, back to RGB.

    It runs in ``x``'s memory layout, as its callers did before the
    kernel: channels last where ``x`` is laid out so (NHWC images seen as
    NCHW), channel planes otherwise. The values do not depend on it, but on
    the CPU which elements PyTorch's pow computes in its vector loop does,
    and with it the last bit of a few of them."""
    cl = not x.is_contiguous() and x.is_contiguous(memory_format=torch.channels_last)
    imgs, ax = (x.permute(0, 2, 3, 1), -1) if cl else (x, 1)
    lab = torch.round(rgb_to_lab_u8(imgs, axis=ax)).to(torch.uint8)
    L = lab.narrow(ax, 0, 1)
    L_eq = clahe_channels(div(L.float(), 255.0), clip_limit, tiles, channels_first=not cl)
    L_u8 = torch.round(L_eq.float() * 255.0).to(torch.uint8)
    lab = torch.cat([L_u8, lab.narrow(ax, 1, 2)], dim=ax)
    out = lab_u8_to_rgb(lab.float(), axis=ax)
    return out.permute(0, 3, 1, 2) if cl else out


def lab_constants() -> Tuple[float, ...]:
    """The Python numbers of :func:`rgb_to_lab_u8` and
    :func:`lab_u8_to_rgb` in the order of ``LabConsts`` in
    ``csrc/clahe.cu``; the kernel gets each as the float32 that PyTorch
    rounds it to (round to nearest)."""
    return (*_RGB2XYZ.ravel().tolist(), *_XYZ2RGB.ravel().tolist(), _XN, _ZN, _LAB_EPS,
            _LAB_KAPPA, _LAB_KAPPA * _LAB_EPS, 1.0 / 3.0, _LAB_SLOPE, _LAB_OFFSET,
            255.0 / 100.0, 100.0 / 255.0, _SRGB_KNEE, _SRGB_SLOPE, 1.0 / _SRGB_GAMMA,
            _SRGB_SCALE, _SRGB_OFFSET)


@functools.cache
def srgb_levels(device: torch.device) -> torch.Tensor:
    """``_srgb_to_linear`` at the 256 levels of an 8-bit channel: the
    kernel's table, made once a device by the plain function itself."""
    return _srgb_to_linear(div(torch.arange(256, dtype=torch.float32, device=device), 255.0))


_LAB_CONSTS = (ctypes.c_float * len(lab_constants()))(*lab_constants())


# ------------------------------------------------------------ the kernels

def _card_plan(H: int, W: int, tiles: int, lab: bool):
    """(th, tw) for a launch, or ValueError where no launch fits: more
    tiles a side than a cluster holds, or a CTA's band, histograms and
    LUTs past its shared memory."""
    if not 1 <= tiles <= MAX_TILES:
        raise ValueError(f"the CLAHE kernels run one CTA a tile row in a thread-block "
                         f"cluster, at most {MAX_TILES} (the portable cluster size): "
                         f"tiles = {tiles}")
    th, tw = tile_geometry(H, W, tiles)
    lib = load_library("clahe")
    if lab and lib.clahe_lab_consts() != len(_LAB_CONSTS):
        raise RuntimeError(f"csrc/clahe.cu takes {lib.clahe_lab_consts()} LAB constants, "
                           f"lab_constants() gives {len(_LAB_CONSTS)}")
    smem = lib.clahe_smem_bytes(W, tiles, th, tw, int(lab))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a {H}x{W} image at {tiles} tiles needs {smem} bytes of shared "
                         f"memory a CTA (its band of {th} rows, histograms and LUTs), over "
                         f"the {MAX_SMEM_BYTES} a CTA can use")
    return th, tw


def cluster_plan(H: int, W: int, tiles: int = 8, lab: bool = False) -> dict:
    """A kernel's launch shape for (H, W) planes (``lab``: images for
    :func:`clahe_rgb`): CTAs a cluster (one a tile row), threads a CTA,
    dynamic shared memory a CTA and how many clusters the card holds at
    once. Builds the library."""
    th, tw = tile_geometry(H, W, tiles)
    lib = load_library("clahe")
    return {"cluster": [tiles, 1, 1], "threads": 256,
            "smem_bytes": lib.clahe_smem_bytes(W, tiles, th, tw, int(lab)),
            "max_active_clusters": lib.clahe_max_active_clusters(W, tiles, th, tw, int(lab))}


def clahe_planes(planes: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8, *,
                 luts_out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CLAHE of (N, H, W) uint8 planes -> (N, H, W) float32 in [0, 1].

    ``luts_out``, an (N, T*T, 256) float32 tensor on the planes' device,
    receives the tile LUTs as well (the checks hold them to
    :func:`clahe_luts_plain`)."""
    _check_planes(planes)
    N, H, W = planes.shape
    if luts_out is not None:
        _check_luts(luts_out, N, tiles, planes.device)
    if not on_card(planes, "CLAHE"):
        luts = clahe_luts_plain(planes, clip_limit, tiles)
        if luts_out is not None:
            luts_out.copy_(luts)
        return div(clahe_apply_plain(planes, luts, tiles), 255.0)
    th, tw = _card_plan(H, W, tiles, lab=False)
    if luts_out is not None and not luts_out.is_contiguous():
        raise ValueError("luts_out must be contiguous")
    planes = planes.contiguous()
    out = torch.empty((N, H, W), dtype=torch.float32, device=planes.device)
    launch("clahe", "clahe", planes.device, planes.data_ptr(), out.data_ptr(),
           None if luts_out is None else luts_out.data_ptr(), N, H, W, tiles, th, tw,
           clip_limit_count(clip_limit, th, tw))
    return out


def clahe_luts(planes: torch.Tensor, clip_limit: float = 1.0,
               tiles: int = 8) -> torch.Tensor:
    """The LUT stage alone: (N, H, W) uint8 planes -> (N, T*T, 256)
    float32. On the card it is one launch of the whole kernel with its
    LUTs written out."""
    _check_planes(planes)
    if planes.device.type == "cpu":
        return clahe_luts_plain(planes, clip_limit, tiles)
    luts = torch.empty((planes.shape[0], tiles * tiles, 256), dtype=torch.float32,
                       device=planes.device)
    clahe_planes(planes, clip_limit, tiles, luts_out=luts)
    return luts


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def clahe_rgb(x: torch.Tensor, clip_limit: float = 1.0, tiles: int = 8) -> torch.Tensor:
    """CLAHE of (B, 3, H, W) float32 RGB images in [0, 1] on the L channel
    of 8-bit LAB -> (B, 3, H, W) float32 in [0, 1], laid out as ``x``.

    On the card one launch of ``clahe_lab_kernel``, which reads ``x``
    through its strides (contiguous NCHW or NHWC images seen as NCHW, no
    copy) and computes :func:`clahe_rgb_plain`'s numbers."""
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[1] != 3:
        raise ValueError(f"expected (B, 3, H, W) float32 images, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if not on_card(x, "CLAHE"):
        return clahe_rgb_plain(x, clip_limit, tiles)
    B, _, H, W = x.shape
    th, tw = _card_plan(H, W, tiles, lab=True)
    out = torch.empty_like(x)
    launch("clahe", "clahe_lab", x.device, x.data_ptr(), out.data_ptr(),
           srgb_levels(x.device).data_ptr(), _LAB_CONSTS, _strides(x), _strides(out), B, H, W,
           tiles, th, tw, clip_limit_count(clip_limit, th, tw))
    return out
