"""CLAHE's two kernels: per-tile LUTs and the bilinear LUT apply.

Port of ``primia_tpu/ops/pallas_clahe.py``. The CUDA kernels live in
``primia_tpu_torch/csrc/clahe.cu`` (their header note says what each
replaces and what bounds it); this module holds their wrappers and, in
the same file, their plain PyTorch versions, which follow the JAX
package's gather path (``primia_tpu/ops/image.py:_clahe_channels``).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``launches`` counts kernel launches,
one per wrapper call that reached the kernel.

Tile geometry: ``T = tiles`` tiles a side, each ``th = ceil(H/T)`` by
``tw = ceil(W/T)`` pixels; the last tile row and column are filled with
the image's edge pixels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

launches = {"clahe_lut": 0, "clahe_apply": 0}

def div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as IEEE division on every device. On CUDA, PyTorch
    divides a tensor by a Python number as a product with the number's
    reciprocal, which can differ in the last bit (and then flip a
    rounding); a one-element divisor on ``x``'s device keeps the true
    quotient, as the kernels and the JAX reference compute it."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


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


@functools.cache
def _lib():
    """``csrc/clahe.cu``, built on first use, with its C signatures."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("clahe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.clahe_lut.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.clahe_lut.restype = ci
    lib.clahe_apply.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.clahe_apply.restype = ci
    lib.clahe_error_string.argtypes = [ci]
    lib.clahe_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.clahe_error_string(err).decode()})")


def _cuda_device(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"CLAHE kernels run on CPU or CUDA tensors, not {t.device}")


# ------------------------------------------------------------ LUT stage

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


def clahe_luts(planes: torch.Tensor, clip_limit: float = 1.0,
               tiles: int = 8) -> torch.Tensor:
    """LUT stage: (N, H, W) uint8 planes -> (N, T*T, 256) float32."""
    _check_planes(planes)
    if planes.device.type == "cpu":
        return clahe_luts_plain(planes, clip_limit, tiles)
    _cuda_device(planes)
    planes = planes.contiguous()
    N, H, W = planes.shape
    th, tw = tile_geometry(H, W, tiles)
    luts = torch.empty((N, tiles * tiles, 256), dtype=torch.float32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.clahe_lut(planes.data_ptr(), luts.data_ptr(), N, H, W, tiles, th, tw,
                            clip_limit_count(clip_limit, th, tw), stream)
    _raise_on(lib, err, "clahe_lut")
    launches["clahe_lut"] += 1
    return luts


# ---------------------------------------------------------- apply stage

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


def clahe_apply(planes: torch.Tensor, luts: torch.Tensor, tiles: int = 8) -> torch.Tensor:
    """Apply stage: (N, H, W) uint8 + LUTs -> (N, H, W) float32 in [0, 255]."""
    _check_planes(planes)
    if planes.device.type == "cpu":
        return clahe_apply_plain(planes, luts, tiles)
    _cuda_device(planes)
    N, H, W = planes.shape
    _check_luts(luts, N, tiles, planes.device)
    if N > 65535:
        raise ValueError(f"clahe_apply takes at most 65535 planes a launch, got {N}")
    planes = planes.contiguous()
    luts = luts.contiguous()
    th, tw = tile_geometry(H, W, tiles)
    out = torch.empty((N, H, W), dtype=torch.float32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.clahe_apply(planes.data_ptr(), luts.data_ptr(), out.data_ptr(),
                              N, H, W, tiles, th, tw, stream)
    _raise_on(lib, err, "clahe_apply")
    launches["clahe_apply"] += 1
    return out
