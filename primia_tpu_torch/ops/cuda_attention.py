"""Swin's window attention as a hand-written kernel pair on the card.

The CUDA kernels live in ``primia_tpu_torch/csrc/window_attention.cu``
(its header note says what they replace, what bounds them and how they
are laid out): one forward launch a call, and one backward launch with a
small finalize that sums the bias gradient's per-CTA partials. They
replace no TPU kernel (the JAX package has no Swin); they replace the
fused attention PyTorch offers, which the port does not call.

The function: for q, k, v of shape (B, nW, h, L, d), d = 32 and L <= 144,
a bias (h, L, L) and, in a shifted block, the windows' region ids (nW, L),

    softmax(q k^T / sqrt(d) + bias [+ MASK_VALUE where two tokens' ids differ]) v,

the bias differentiated with q, k and v. The kernels pick their build from
the input: bf16 on the tensor cores (the train step's autocast), float32
on the CUDA cores with no TF32 (the eval and predict steps); L padded
inside to a multiple of 16. They read q, k, v and the output's gradient
through their strides and write o, dq, dk and dv as (B, nW, L, h, d)
buffers, returned as (B, nW, h, L, d) views: the qkv linear's output and
proj's input need no copy.

A CPU tensor takes the plain version, :func:`window_attention_plain`; a
CUDA tensor launches the kernels or raises. ``_build.launches`` counts
kernel calls by direction, one a call each way.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from primia_tpu_torch.ops._build import declare, launch, on_card, sm_count

_i64s = ctypes.POINTER(ctypes.c_longlong)
_ARGS = [_i64s, _i64s, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_int]
declare("window_attention", {"window_attention_fwd": _ARGS, "window_attention_bwd": _ARGS})

HEAD_DIM = 32
MAX_TOKENS = 144
# the logit offset of two tokens of different regions of a shifted window,
# as published (exp(-100) underflows against the row's own terms)
MASK_VALUE = -100.0

# ptrs and strides of the C launchers: the first seven operands' (b, w, h, l)
# strides, then the bias's (h, i, j)
_OPERANDS = ("q", "k", "v", "o", "dq", "dk", "dv")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
           regions: Optional[torch.Tensor]) -> None:
    """Raises a ValueError on operands the kernels do not take, on every
    device: d other than 32, L over 144, a bias or region ids of another
    shape, operands of two dtypes or devices."""
    if q.dim() != 5 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window attention takes q, k, v of one (B, nW, h, L, d) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    _, nW, h, L, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"window attention takes head dim {HEAD_DIM}, got {d}")
    if L > MAX_TOKENS:
        raise ValueError(f"window attention takes at most {MAX_TOKENS} tokens a window, got {L}")
    if tuple(bias.shape) != (h, L, L):
        raise ValueError(f"the bias must be ({h}, {L}, {L}), got {tuple(bias.shape)}")
    if regions is not None and (tuple(regions.shape) != (nW, L) or regions.is_floating_point()):
        raise ValueError(f"region ids must be ({nW}, {L}) integers, got "
                         f"{tuple(regions.shape)} {regions.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v in {q.dtype}, {k.dtype}, {v.dtype}")
    others = [t for t in (k, v, bias, regions) if t is not None]
    if any(t.device != q.device for t in others):
        raise ValueError("window attention's operands are on more than one device")


def region_mask(regions: torch.Tensor) -> torch.Tensor:
    """(nW, L) region ids -> (nW, L, L) bool: True where two tokens of a
    window lie in different regions."""
    return regions[:, :, None] != regions[:, None, :]


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor, regions: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """The explicit softmax(q k^T / sqrt(d) + bias [+ MASK_VALUE where
    masked]) v in plain PyTorch, in q's dtype; differentiable."""
    logits = q @ k.transpose(-1, -2) * q.shape[-1] ** -0.5 + bias.to(q.dtype)
    if regions is not None:
        logits = logits + (region_mask(regions) * MASK_VALUE).to(q.dtype)[None, :, None]
    return torch.softmax(logits, -1) @ v


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the kernels can read or write it through its strides:
    d's stride 1 and, in bf16, every row on a 16-byte boundary (the
    kernels copy 16 bytes at a time); otherwise a contiguous copy."""
    ok = t.stride(-1) == 1
    if ok and t.dtype == torch.bfloat16:
        ok = t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:-1])
    return t if ok else t.contiguous()


def _rows_buffer(q: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, nW, L, h, d) buffer in q's dtype, seen as
    (B, nW, h, L, d)."""
    B, nW, h, L, d = q.shape
    return torch.empty((B, nW, L, h, d), dtype=q.dtype, device=q.device).permute(0, 1, 3, 2, 4)


def _launch_args(nblk: int, tensors: dict, bias: torch.Tensor, regions: Optional[torch.Tensor],
                 lse: torch.Tensor, partial: Optional[torch.Tensor],
                 dbias: Optional[torch.Tensor]) -> tuple:
    """A launcher's arguments before the stream, ``nblk`` CTAs a head
    (:func:`_blocks`); ``tensors`` maps the operands' names to their
    tensors."""
    q = tensors["q"]
    B, nW, h, L, d = q.shape
    ptrs = [tensors[n].data_ptr() if n in tensors else 0 for n in _OPERANDS]
    ptrs += [bias.data_ptr(), 0 if regions is None else regions.data_ptr(), lse.data_ptr(),
             0 if partial is None else partial.data_ptr(),
             0 if dbias is None else dbias.data_ptr()]
    strides = [s for n in _OPERANDS
               for s in (tensors[n].stride()[:4] if n in tensors else (0, 0, 0, 0))]
    strides += list(bias.stride())
    return ((ctypes.c_longlong * len(ptrs))(*ptrs), (ctypes.c_longlong * len(strides))(*strides),
            B, nW, h, L, d ** -0.5, int(q.dtype == torch.float32), nblk)


def _blocks(q: torch.Tensor) -> int:
    """CTAs a head: one CTA an SM over the heads, at most one a window."""
    B, nW, h = q.shape[:3]
    return max(1, min(B * nW, sm_count(q.device) // h))


def _cuda_operands(q, k, v, bias, regions):
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"window attention on the card takes bfloat16 or float32, got {q.dtype}")
    return (*(_aligned(t) for t in (q, k, v)), bias.float(),
            None if regions is None else regions.to(torch.int32).contiguous())


def forward(q, k, v, bias, regions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on checked CUDA operands (:func:`_cuda_operands`):
    o as a (B, nW, h, L, d) view of a (B, nW, L, h, d) buffer, and the rows'
    log-sum-exp, (B nW, h, L) float32."""
    B, nW, h, L, _ = q.shape
    o = _rows_buffer(q)
    lse = torch.empty((B * nW, h, L), dtype=torch.float32, device=q.device)
    launch("window_attention", "window_attention_fwd", q.device,
           *_launch_args(_blocks(q), {"q": q, "k": k, "v": v, "o": o}, bias, regions, lse, None,
                         None))
    return o, lse


def backward(q, k, v, do, bias, regions, lse
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One backward launch and its finalize: dq, dk, dv as views like
    :func:`forward`'s o, and the bias gradient, (h, L, L) float32."""
    B, nW, h, L, _ = q.shape
    dq, dk, dv = (_rows_buffer(q) for _ in range(3))
    nblk = _blocks(q)
    partial = torch.empty((h, nblk, L, L), dtype=torch.float32, device=q.device)
    dbias = torch.empty((h, L, L), dtype=torch.float32, device=q.device)
    launch("window_attention", "window_attention_bwd", q.device,
           *_launch_args(nblk, {"q": q, "k": k, "v": v, "o": do, "dq": dq, "dk": dk, "dv": dv},
                         bias, regions, lse, partial, dbias))
    return dq, dk, dv, dbias


class _WindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, regions):
        ctx.bias_dtype = bias.dtype
        q, k, v, bias, regions = _cuda_operands(q, k, v, bias, regions)
        o, lse = forward(q, k, v, bias, regions)
        ctx.save_for_backward(q, k, v, bias, regions, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, regions, lse = ctx.saved_tensors
        if do.shape != q.shape or do.dtype != q.dtype:
            raise ValueError(f"the output's gradient is {tuple(do.shape)} {do.dtype}, the "
                             f"output {tuple(q.shape)} {q.dtype}")
        dq, dk, dv, dbias = backward(q, k, v, _aligned(do), bias, regions, lse)
        return dq, dk, dv, dbias.to(ctx.bias_dtype), None


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                     regions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d) + bias [+ MASK_VALUE between regions]) v
    for q, k, v (B, nW, h, L, d), bias (h, L, L), region ids (nW, L) or
    None: the plain version on the CPU, the kernels on the card
    (differentiable in q, k, v and the bias either way)."""
    _check(q, k, v, bias, regions)
    if not on_card(q, "window attention"):
        return window_attention_plain(q, k, v, bias, regions)
    return _WindowAttention.apply(q, k, v, bias, regions)
