"""The augmentation warps' two kernels: K1, the 1-D lerp of the two-pass
warps, and K2, the exact bilinear gather.

Port of ``primia_tpu/ops/pallas_tent.py``. The CUDA kernels live in
``primia_tpu_torch/csrc/tent.cu``; their header note names the TPU kernel
each replaces (``_rows_kernel`` of ``_resample_rows``, and ``_tent_kernel``
of ``resample_tent_pallas``) and states the bound: both are memory-bound,
0.084 ms (K1, one pass) and 0.096 ms (K2) at 200 images x 3 channels of
224x224 in float32 at 3.35 TB/s. This module holds their wrappers and, in
the same file, their plain PyTorch versions.

Both work in float32, in and out: the TPU kernels cast pixels to bf16,
while the port's pixel pipeline stays f32 on every device.

Layout: planes ``(N, H, W)`` with ``N = B * C`` (the C channel planes of
an image next to each other) and coordinate fields ``(B, Ho, Wo)``,
shared by the C planes of an image.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``launches`` counts kernel launches,
one per wrapper call that reached the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

launches = {"tent_rows": 0, "tent_bilinear": 0}


def _check(planes: torch.Tensor, *coords: torch.Tensor) -> int:
    """Validates the operands; returns C, the planes per image."""
    if planes.dtype != torch.float32 or planes.dim() != 3:
        raise ValueError(f"expected (N, H, W) float32 planes, got "
                         f"{tuple(planes.shape)} {planes.dtype}")
    shape = coords[0].shape
    for c in coords:
        if c.dtype != torch.float32 or c.dim() != 3 or c.shape != shape:
            raise ValueError(f"expected (B, Ho, Wo) float32 coordinates of one shape, got "
                             f"{[(tuple(t.shape), t.dtype) for t in coords]}")
        if c.device != planes.device:
            raise ValueError(f"coordinates on {c.device}, planes on {planes.device}")
    B, N = shape[0], planes.shape[0]
    if B == 0 or N % B:
        raise ValueError(f"{N} planes do not split into {B} images")
    return N // B


def _check_rows(planes: torch.Tensor, coords: torch.Tensor, axis: int) -> int:
    C = _check(planes, coords)
    if axis not in (1, 2):
        raise ValueError(f"axis must be 1 (along H) or 2 (along W), got {axis}")
    if coords.shape[1:] != planes.shape[1:]:
        raise ValueError(f"field {tuple(coords.shape)} does not match planes "
                         f"{tuple(planes.shape)}")
    return C


def _cuda_device(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"the warp kernels run on CPU or CUDA tensors, not {t.device}")


@functools.cache
def _lib():
    """``csrc/tent.cu``, built on first use, with its C signatures."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("tent")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.tent_rows.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, vp]
    lib.tent_rows.restype = ci
    lib.tent_bilinear.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp]
    lib.tent_bilinear.restype = ci
    lib.tent_error_string.argtypes = [ci]
    lib.tent_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{what} launch failed: CUDA error {err} "
            f"({lib.tent_error_string(err).decode()})")


def _per_plane(t: torch.Tensor, C: int) -> torch.Tensor:
    """(B, ...) -> (B*C, ...): each image's field for each of its planes."""
    return t.repeat_interleave(C, dim=0) if C > 1 else t


def _tap(planes: torch.Tensor, dim: int, k: torch.Tensor) -> torch.Tensor:
    """``planes`` gathered at index ``k`` along ``dim``, 0 where ``k`` is
    outside the plane."""
    L = planes.shape[dim]
    valid = (k >= 0) & (k < L)
    v = torch.gather(planes, dim, k.clamp(0, L - 1))
    return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))


def _floor_index(q: torch.Tensor, L: int):
    """(clamped integer floor, fraction) of ``q``: the floor is clamped to
    [-2, L+1], where both taps stay outside the plane, as in the kernels."""
    q0 = torch.floor(q)
    return q0.clamp(-2.0, L + 1.0).long(), q - q0


# ------------------------------------------------------------------ K1

def tent_rows_plain(planes: torch.Tensor, coords: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """The 1-D lerp of ``tent_rows``, in plain PyTorch."""
    C = _check_rows(planes, coords, axis)
    k0, f = _floor_index(_per_plane(coords, C), planes.shape[axis])
    return _tap(planes, axis, k0) * (1.0 - f) + _tap(planes, axis, k0 + 1) * f


def tent_rows(planes: torch.Tensor, coords: torch.Tensor, axis: int = 2) -> torch.Tensor:
    """K1: ``out[n,i,j]`` is plane ``n`` read at the fractional position
    ``q = coords[n // C, i, j]`` along ``axis``, linearly between its two
    neighbours, 0 outside the plane (zero fill outside [-1, L]).

    ``axis=2``, the row form: ``lerp(planes[n, i, :], q)``;
    ``axis=1``, the column form: ``lerp(planes[n, :, j], q)``.
    planes (B*C, H, W) and coords (B, H, W), float32.
    """
    C = _check_rows(planes, coords, axis)
    if planes.device.type == "cpu":
        return tent_rows_plain(planes, coords, axis)
    _cuda_device(planes)
    planes, coords = planes.contiguous(), coords.contiguous()
    N, H, W = planes.shape
    out = torch.empty_like(planes)
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.tent_rows(planes.data_ptr(), coords.data_ptr(), out.data_ptr(), N, C, H, W,
                            int(axis == 1), stream)
    _raise_on(lib, err, "tent_rows")
    launches["tent_rows"] += 1
    return out


# ------------------------------------------------------------------ K2

def tent_bilinear_plain(planes: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """The 4-tap bilinear gather of ``tent_bilinear``, in plain PyTorch,
    in ``primia_tpu/ops/image.py:bilinear_sample``'s order."""
    C = _check(planes, ys, xs)
    N, H, W = planes.shape
    Ho, Wo = ys.shape[1:]
    y0, wy = _floor_index(_per_plane(ys, C), H)
    x0, wx = _floor_index(_per_plane(xs, C), W)
    flat = planes.reshape(N, H * W)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(N, Ho * Wo)
        v = torch.gather(flat, 1, idx).reshape(N, Ho, Wo)
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))

    top = tap(y0, x0) * (1.0 - wx) + tap(y0, x0 + 1) * wx
    bot = tap(y0 + 1, x0) * (1.0 - wx) + tap(y0 + 1, x0 + 1) * wx
    return top * (1.0 - wy) + bot * wy


def tent_bilinear(planes: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                  max_dy: Optional[float] = None) -> torch.Tensor:
    """K2: exact bilinear sampling of each plane at absolute source
    coordinates ``(ys, xs)`` of its image, zero fill per tap.

    planes (B*C, H, W); ys, xs (B, Ho, Wo); out (B*C, Ho, Wo); float32.
    ``max_dy`` is the TPU kernel's static row-band guarantee
    (``|ys - output row| <= max_dy``). It only saved multiply-adds of the
    TPU's tent contraction, and the result under the guarantee is the
    same, so a gather ignores it: it is accepted and moot.
    """
    C = _check(planes, ys, xs)
    if planes.device.type == "cpu":
        return tent_bilinear_plain(planes, ys, xs)
    _cuda_device(planes)
    planes, ys, xs = planes.contiguous(), ys.contiguous(), xs.contiguous()
    N, H, W = planes.shape
    Ho, Wo = ys.shape[1:]
    out = torch.empty((N, Ho, Wo), dtype=torch.float32, device=planes.device)
    lib = _lib()
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.tent_bilinear(planes.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                out.data_ptr(), N, C, H, W, Ho, Wo, stream)
    _raise_on(lib, err, "tent_bilinear")
    launches["tent_bilinear"] += 1
    return out
