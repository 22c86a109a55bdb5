"""The per-channel sums of train-mode batch norm (K8), and the batch norm
built on them.

Port of ``primia_tpu/ops/pallas_bn.py``. The CUDA kernels live in
``primia_tpu_torch/csrc/bn.cu``; its header note names the TPU kernels they
replace (``_sums_kernel``/``_gsums_kernel`` of ``_run_reduce`` and their
batch-minor twins of ``_run_reduce_bm``) and states their bound. This
module holds their wrappers, their plain PyTorch versions and
:func:`bn_train`, the ``torch.autograd.Function`` counterpart of the JAX
package's ``custom_vjp``.

The TPU lays the sums out two ways for its lanes (row-major, and a
batch-minor view for C < 128); here every activation is ``channels_last``,
so the kernels read one (N*H*W, C) matrix, rows contiguous. The wrappers
check the layout that arrives, the gradient in the backward included:
``layout_copies`` counts each operand they had to copy into
``channels_last`` first (PyTorch's copy kernel, in a profile).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``launches`` counts kernel launches, one
per wrapper call that reached the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Tuple

import torch

from primia_tpu_torch.ops.numerics import div

launches = {"bn_sums": 0, "bn_grad_sums": 0}
layout_copies = {"bn_sums": 0, "bn_grad_sums": 0}

_THREADS = 256
_MAX_BLOCKS = 528  # 4 blocks of 256 threads on each of 132 SMs
_UNROLL = 4


def use_pallas_bn() -> bool:
    """``PRIMIA_PALLAS_BN=1`` routes every train-mode batch norm of a 4-D
    bfloat16 activation through :func:`bn_train` (``nn/core.py:Norm``). The
    JAX package honours the switch only on a TPU; the port honours it on
    every device: on CUDA the sums launch K8, on the CPU they run K8's
    plain versions."""
    return os.environ.get("PRIMIA_PALLAS_BN", "0") == "1"


def _rows(t: torch.Tensor, name: str, count: bool) -> torch.Tensor:
    """A (N, C, H, W) or (R, C) bfloat16 tensor as its (rows, C) matrix,
    rows contiguous: a view of a ``channels_last`` activation, otherwise a
    copy, counted under ``name`` when ``count``."""
    if t.dtype != torch.bfloat16 or t.dim() not in (2, 4):
        raise ValueError(f"expected a (N, C, H, W) or (R, C) bfloat16 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if t.dim() == 4:
        if not t.is_contiguous(memory_format=torch.channels_last):
            if count:
                layout_copies[name] += 1
            t = t.contiguous(memory_format=torch.channels_last)
        return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])
    if not t.is_contiguous():
        if count:
            layout_copies[name] += 1
        t = t.contiguous()
    return t


@functools.cache
def _lib():
    """``csrc/bn.cu``, built on first use, with its C signatures."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("bn")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bn_sums.argtypes = [vp, vp, vp, ll, ci, ci, vp]
    lib.bn_sums.restype = ci
    lib.bn_grad_sums.argtypes = [vp, vp, vp, vp, ll, ci, ci, vp]
    lib.bn_grad_sums.restype = ci
    lib.bn_error_string.argtypes = [ci]
    lib.bn_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name: str, rows2d) -> Tuple[torch.Tensor, torch.Tensor]:
    x = rows2d[-1]
    R, C = x.shape
    if C % 8 or C > 8 * _THREADS:
        raise ValueError(f"K8 takes C a multiple of 8, at most {8 * _THREADS}; got {C}")
    if any(t.data_ptr() % 16 for t in rows2d):
        raise ValueError("K8 reads 16 bytes at a time: operands must be 16-byte aligned")
    rows_per_block = (_THREADS // (C // 8)) * _UNROLL
    nblocks = max(1, min(_MAX_BLOCKS, -(-R // rows_per_block)))
    partial = torch.empty((nblocks, 2, C), dtype=torch.float32, device=x.device)
    out = torch.empty((2, C), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ptrs = [t.data_ptr() for t in rows2d]
        err = getattr(lib, name)(*ptrs, partial.data_ptr(), out.data_ptr(), R, C, nblocks,
                                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.bn_error_string(err).decode()})")
    launches[name] += 1
    return out[0], out[1]


def _cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"K8 runs on CPU or CUDA tensors, not {t.device}")


def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) per channel in float32, in plain PyTorch."""
    xf = _rows(x, "bn_sums", count=False).float()
    return xf.sum(0), (xf * xf).sum(0)


def grad_channel_sums_plain(g: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum g, sum g*x) per channel in float32, in plain PyTorch."""
    gf = _rows(g, "bn_grad_sums", count=False).float()
    xf = _rows(x, "bn_grad_sums", count=False).float()
    return gf.sum(0), (gf * xf).sum(0)


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (sum x, sum x^2) over every axis but the channel (dim 1 of a
    4-D tensor, the last of a 2-D one), float32, in one read of the
    bfloat16 ``x``: ``pallas_bn.py:channel_sums``."""
    if x.device.type == "cpu":
        return channel_sums_plain(x)
    _cuda(x)
    return _launch("bn_sums", [_rows(x, "bn_sums", count=True)])


def grad_channel_sums(g: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: (sum g, sum g*x) per channel, float32, in one read of the
    bfloat16 pair: ``pallas_bn.py:grad_channel_sums``."""
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} and x {tuple(x.shape)} on "
                         f"{x.device} differ")
    if x.device.type == "cpu":
        return grad_channel_sums_plain(g, x)
    _cuda(x)
    return _launch("bn_grad_sums", [_rows(g, "bn_grad_sums", count=True),
                                    _rows(x, "bn_grad_sums", count=True)])


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


class _BnTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        n = float(x.numel() // x.shape[1])
        s1, s2 = channel_sums(x)
        mean = div(s1, n)
        var = torch.addcmul(div(s2, n), mean, mean, value=-1.0).clamp_min_(0.0)
        r = torch.rsqrt(var + eps)
        inv = gamma.float() * r
        off = torch.addcmul(beta.float(), mean, inv, value=-1.0)
        # y = x * inv + off in float32, rounded once to x's dtype as
        # F.batch_norm rounds it (the JAX package rounds inv and off to
        # bfloat16 first, pallas_bn.py:261), in one pass: the switch then
        # moves only where the sums run
        y = torch.addcmul(_chan(off), x, _chan(inv), out=torch.empty_like(x))
        ctx.save_for_backward(x, gamma, mean, r)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, r = ctx.saved_tensors
        n = float(x.numel() // x.shape[1])
        S1, S2 = grad_channel_sums(gy, x)
        dgamma = torch.addcmul(S2, mean, S1, value=-1.0).mul_(r)
        # dx = gamma r (g - S1/n - xhat dgamma/n), xhat = (x - mean) r,
        #    = A g + B x + D with per-channel A = gamma r, B = -A r m and
        #    D = A (r m mean - S1/n), m = dgamma/n (pallas_bn.py:_bn_bwd);
        #    the sum in float32, rounded once to x's dtype
        A = gamma.float() * r
        rm = r * div(dgamma, n)
        B = torch.mul(A, rm).neg_()
        D = torch.addcmul(div(S1, n), rm, mean, value=-1.0).mul_(A).neg_()
        dx = torch.addcmul(torch.addcmul(_chan(D), gy, _chan(A)), x, _chan(B),
                           out=torch.empty_like(x))
        return dx, dgamma.to(gamma.dtype), S1.to(gamma.dtype), None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode batch norm of a (N, C, H, W) bfloat16 ``x``; returns
    (y, mean, biased var), y in x's dtype, mean and var float32 (for the
    running statistics; not differentiated). ``pallas_bn.py:bn_train``:
    the statistics from :func:`channel_sums` in the forward, the gradients
    of gamma and beta from :func:`grad_channel_sums` in the backward; the
    elementwise normalise and dx stay PyTorch ops."""
    return _BnTrain.apply(x, gamma, beta, eps)
