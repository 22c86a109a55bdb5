"""CLAHE as one kernel: per-tile LUTs, their bilinear apply and the
division by 255, from uint8 planes to [0, 1] floats.

Port of ``primia_tpu/ops/pallas_clahe.py`` (its two ``pallas_call``s and
the ``/ 255.0`` after them). The CUDA kernel lives in
``primia_tpu_torch/csrc/clahe.cu`` (its header note says what it replaces,
what bounds it and how it is laid out); this module holds its wrapper
and, in the same file, its plain PyTorch version, which follows the JAX
package's gather path (``primia_tpu/ops/image.py:_clahe_channels``) in
two stages, the LUTs and their apply.

The wrapper given a CPU tensor runs the plain version; given a CUDA
tensor it launches the kernel or raises. ``launches`` counts kernel
launches, one per wrapper call that reached the kernel.

Tile geometry: ``T = tiles`` tiles a side, each ``th = ceil(H/T)`` by
``tw = ceil(W/T)`` pixels; the last tile row and column are filled with
the image's edge pixels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from primia_tpu_torch.ops.numerics import div

launches = {"clahe": 0}

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


@functools.cache
def _lib():
    """``csrc/clahe.cu``, built on first use, with its C signatures."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("clahe")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.clahe.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp]
    lib.clahe.restype = ci
    lib.clahe_smem_bytes.argtypes = [ci, ci, ci, ci]
    lib.clahe_smem_bytes.restype = ci
    lib.clahe_max_active_clusters.argtypes = [ci, ci, ci, ci]
    lib.clahe_max_active_clusters.restype = ci
    lib.clahe_error_string.argtypes = [ci]
    lib.clahe_error_string.restype = ctypes.c_char_p
    return lib


def _cuda_device(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"CLAHE runs on CPU or CUDA tensors, not {t.device}")


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


# ------------------------------------------------------------ the kernel

def cluster_plan(H: int, W: int, tiles: int = 8) -> dict:
    """The kernel's launch shape for (H, W) planes: CTAs a cluster (one
    a tile row), threads a CTA, dynamic shared memory a CTA and how many
    clusters the card holds at once. Builds the library."""
    th, tw = tile_geometry(H, W, tiles)
    lib = _lib()
    return {"cluster": [tiles, 1, 1], "threads": 256,
            "smem_bytes": lib.clahe_smem_bytes(W, tiles, th, tw),
            "max_active_clusters": lib.clahe_max_active_clusters(W, tiles, th, tw)}


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
    if planes.device.type == "cpu":
        luts = clahe_luts_plain(planes, clip_limit, tiles)
        if luts_out is not None:
            luts_out.copy_(luts)
        return div(clahe_apply_plain(planes, luts, tiles), 255.0)
    _cuda_device(planes)
    if not 1 <= tiles <= MAX_TILES:
        raise ValueError(f"the CLAHE kernel runs one CTA a tile row in a thread-block "
                         f"cluster, at most {MAX_TILES} (the portable cluster size): "
                         f"tiles = {tiles}")
    th, tw = tile_geometry(H, W, tiles)
    lib = _lib()
    smem = lib.clahe_smem_bytes(W, tiles, th, tw)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a {H}x{W} plane at {tiles} tiles needs {smem} bytes of shared "
                         f"memory a CTA (its band of {th} rows, histograms and LUTs), over "
                         f"the {MAX_SMEM_BYTES} a CTA can use")
    if luts_out is not None and not luts_out.is_contiguous():
        raise ValueError("luts_out must be contiguous")
    planes = planes.contiguous()
    out = torch.empty((N, H, W), dtype=torch.float32, device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.clahe(planes.data_ptr(), out.data_ptr(),
                        None if luts_out is None else luts_out.data_ptr(), N, H, W, tiles,
                        th, tw, clip_limit_count(clip_limit, th, tw), stream)
    if err != 0:
        raise RuntimeError(f"clahe launch failed: CUDA error {err} "
                           f"({lib.clahe_error_string(err).decode()})")
    launches["clahe"] += 1
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
