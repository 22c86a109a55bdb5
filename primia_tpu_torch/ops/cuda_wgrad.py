"""The weight gradient of a 3x3, stride-1, pad-1 convolution (K7), and the
convolution whose backward runs it.

Port of ``primia_tpu/ops/pallas_wgrad.py``. The CUDA kernel lives in
``primia_tpu_torch/csrc/wgrad.cu``; its header note names the TPU kernels
it replaces (``_wgrad_kernel`` and ``_wgrad_kernel_v2``) and states its
bound. This module holds its wrapper, its plain PyTorch version and
:func:`conv3x3_s1p1`, the ``torch.autograd.Function`` counterpart of the
JAX package's ``custom_vjp``.

Layout: the JAX package's x (B, H, W, ci) and g (B, H, W, co) are here
NCHW tensors in ``channels_last`` memory, the same bytes; dW is OIHW
(co, ci, 3, 3) instead of HWIO (3, 3, ci, co). Both operands are read as
bfloat16 and the sums run in float32.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``launches`` counts kernel launches, one
per wrapper call that reached the kernel; ``layout_copies`` counts the
operands the wrapper had to copy into bfloat16 ``channels_last`` first
(the copy shows in a profile as PyTorch's own copy kernel).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

launches = {"conv3x3_wgrad": 0}
layout_copies = {"conv3x3_wgrad": 0}

# blocks the split of the pixel axis aims at: the 2 a 132-SM card holds per SM
# (125 registers a thread, 256 threads a block)
_TARGET_BLOCKS = 264
_TILE = 128  # the kernel's M and N tile
_STEP = 32   # the kernel's pixels a step: a split is a multiple of it


def use_pallas_wgrad() -> bool:
    """``PRIMIA_PALLAS_WGRAD=1`` routes the train step's 3x3/s1/p1 convs
    with at least 128 channels in and out, computed in bfloat16, through
    :func:`conv3x3_s1p1` (``nn/core.py:Conv``). The JAX package honours the
    switch only on a TPU; the port honours it on every device: on CUDA the
    weight gradient launches K7, on the CPU it runs K7's plain version."""
    return os.environ.get("PRIMIA_PALLAS_WGRAD", "0") == "1"


def _check(x: torch.Tensor, g: torch.Tensor) -> None:
    if x.dim() != 4 or g.dim() != 4 or x.shape[0] != g.shape[0] or x.shape[2:] != g.shape[2:]:
        raise ValueError(f"expected x (B, ci, H, W) and g (B, co, H, W), got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")
    if not (x.is_floating_point() and g.is_floating_point()):
        raise ValueError(f"expected float operands, got {x.dtype} and {g.dtype}")
    if x.device != g.device:
        raise ValueError(f"x on {x.device}, g on {g.device}")


@functools.cache
def _lib():
    """``csrc/wgrad.cu``, built on first use, with its C signature."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("wgrad")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.conv3x3_wgrad.argtypes = [vp, vp, vp, vp, ll, ci, ci, ci, ci, ci, ll, vp]
    lib.conv3x3_wgrad.restype = ci
    lib.wgrad_error_string.argtypes = [ci]
    lib.wgrad_error_string.restype = ctypes.c_char_p
    return lib


def _bf16_channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` as bfloat16 in ``channels_last`` memory, copied (and counted)
    only if it is not already."""
    if t.dtype == torch.bfloat16 and t.is_contiguous(memory_format=torch.channels_last):
        return t
    layout_copies["conv3x3_wgrad"] += 1
    return t.to(dtype=torch.bfloat16, memory_format=torch.channels_last)


def split_pixels(P: int, ci: int, co: int):
    """(splits, pixels a split) of the kernel's K axis: as many blocks as
    fill the card in one wave and no more (a second, part-filled wave
    would double the time), each split a multiple of the kernel's step and
    none empty."""
    tiles = -(-3 * ci // _TILE) * -(-3 * co // _TILE)
    splits = max(1, min(_TARGET_BLOCKS // tiles, -(-P // _STEP)))
    chunk = -(-P // (splits * _STEP)) * _STEP
    return -(-P // chunk), chunk


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7's function in plain PyTorch: the nine shifted products of the
    formula, each a float32 matrix product of g (co, B*H*W) and the
    shifted x (B*H*W, ci), from the operands rounded to bfloat16."""
    _check(x, g)
    B, ci, H, W = x.shape
    co = g.shape[1]
    xp = F.pad(x.to(torch.bfloat16).float(), (1, 1, 1, 1))
    g2 = g.to(torch.bfloat16).float().permute(1, 0, 2, 3).reshape(co, -1)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    for kh in range(3):
        for kw in range(3):
            xs = xp[:, :, kh:kh + H, kw:kw + W].permute(0, 2, 3, 1).reshape(-1, ci)
            dw[:, :, kh, kw] = g2 @ xs
    return dw


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K7: dW[o, c, kh, kw] = sum_{b,h,w} x[b, c, h+kh-1, w+kw-1] g[b, o, h, w]
    (zero outside the image), float32 (co, ci, 3, 3), for y = conv(x, w,
    stride 1, padding 1) and its cotangent g. The contract of the JAX
    package's ``conv3x3_wgrad_pallas`` in NCHW / OIHW. On CUDA, ci and co
    must be multiples of 8 and B*H*W below 2^31."""
    _check(x, g)
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    if x.device.type != "cuda":
        raise RuntimeError(f"K7 runs on CPU or CUDA tensors, not {x.device}")
    B, ci, H, W = x.shape
    co = g.shape[1]
    if ci % 8 or co % 8:
        raise ValueError(f"K7 takes channel counts that are multiples of 8, got {ci} and {co}")
    P = B * H * W
    if P >= 2 ** 31 - 64:
        raise ValueError(f"K7 takes fewer than 2^31 pixels, got {P}")
    x, g = _bf16_channels_last(x), _bf16_channels_last(g)
    splits, chunk = split_pixels(P, ci, co)
    mpad, npad = -(-3 * ci // _TILE) * _TILE, -(-3 * co // _TILE) * _TILE
    ws = torch.empty((splits, mpad, npad), dtype=torch.float32, device=x.device)
    dw = torch.empty((co, ci, 3, 3), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_wgrad(x.data_ptr(), g.data_ptr(), ws.data_ptr(), dw.data_ptr(), P,
                                H, W, ci, co, splits, chunk, stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_wgrad launch failed: CUDA error {err} "
                           f"({lib.wgrad_error_string(err).decode()})")
    launches["conv3x3_wgrad"] += 1
    return dw


def conv3x3_wgrad_v2(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The contract of ``conv3x3_wgrad_pallas_v2``. The TPU's two schedules
    differ only in where they build the halos; on Hopper both are
    :func:`conv3x3_wgrad`."""
    return conv3x3_wgrad(x, g)


class _Conv3x3S1P1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad
        # K7 where the JAX package runs its kernel (pallas_wgrad.py:_bwd):
        # the C = 512 stage keeps the library's weight gradient
        on_k7 = need_w and max(x.shape[1], g.shape[1]) <= 256
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [need_x, need_w and not on_k7, False])
        if on_k7:
            # w's dtype and memory format, as the library's gradient has them
            dw = torch.empty_like(w).copy_(conv3x3_wgrad(x, g))
        return dx, dw


def conv3x3_s1p1(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A 3x3, stride-1, pad-1 convolution (NCHW, OIHW weights) whose weight
    gradient runs on K7 when max(ci, co) <= 256, as
    ``primia_tpu/ops/pallas_wgrad.py:conv3x3_s1p1``: the forward is
    ``F.conv2d`` and the data gradient the library's own, as the JAX
    package left both to XLA; where the weight gradient is K7's, it is
    cast to ``w``'s dtype (bfloat16 on the train path, rounded from K7's
    float32 as the JAX package's ``.astype(w.dtype)``)."""
    return _Conv3x3S1P1.apply(x, w)
