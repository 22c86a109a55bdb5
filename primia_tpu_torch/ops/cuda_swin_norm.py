"""Swin's and MaxViT's layer norms as one hand-written kernel pair on the
card, fused with the row permutations, the residual add and the cast around
them.

The CUDA kernels live in ``primia_tpu_torch/csrc/swin_norm.cu`` (its header
note says what they replace, what bounds them and how they are laid out):
one forward launch a call, and one backward launch with a small finalize
that sums the gamma and beta gradients' per-CTA partials. They replace no
TPU kernel (the JAX package has no Swin).

An *order* is ``(window, shift)``: the (B, H, W, C) map rolled by (-shift,
-shift) and partitioned into windows in row-major order, (B, nW, L, C),
exactly ``torch.roll`` then :func:`window_partition`; or ``(G, GRID)``: the
map partitioned into a G x G grid, exactly :func:`grid_partition` (MaxViT's
grid attention, ``nn/maxvit.py``); None is the natural (B, H, W, C) order.
:func:`add_norm` takes x (B, H, W, C) and optionally a branch at
``branch_order``; it returns the residual stream ``s = x + branch`` in
natural order (x itself where no branch is given) and ``y =
layer_norm(s)`` at ``out_order`` in ``out_dtype``. Its backward reads the
gradient of y at ``out_order`` and the residual stream's own gradient (of
s), and writes x's gradient in natural order, the two summed, and the
branch's at its order: no add is left to autograd. Every step rounds as the
composition it
replaces rounds: the add in the operands' promoted dtype, the layer norm in
float32 (as autocast runs it), y rounded once to ``out_dtype``.

A CPU tensor takes the plain version, :func:`add_norm_plain` (that
composition); a CUDA tensor launches the kernels or raises.
``_build.launches`` counts kernel calls by direction, one a call each way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from primia_tpu_torch.ops._build import declare, launch, on_card, query, sm_count

Order = Optional[Tuple[int, int]]
# an order's second element that names a grid: (G, GRID)
GRID = -1

_vp, _ci, _ll, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SHAPE = [_ll, _ci, _ci, _ci, _ci, _ci, _ci, _ci, _ci]  # rows, H, W, C, dtypes, two orders
declare("swin_norm", {"swin_norm_fwd": [_vp] * 7 + _SHAPE + [_cf],
                      "swin_norm_bwd": [_vp] * 9 + _SHAPE + [_ci]},
        queries={"swin_norm_bwd_blocks_per_sm": [_ci]})

MAX_C = 4096
_DTYPES = (torch.float32, torch.bfloat16)
_X_BF16, _BRANCH_BF16, _OUT_BF16 = 1, 2, 4


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, window^2, C), windows in row-major order."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C).transpose(2, 3)
    return x.reshape(B, (H // window) * (W // window), window * window, C)


def window_reverse(x: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`."""
    B, _, _, C = x.shape
    x = x.reshape(B, H // window, W // window, window, window, C).transpose(2, 3)
    return x.reshape(B, H, W, C)


def grid_partition(x: torch.Tensor, grid: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, nW, grid^2, C): window (a, b) of the (H / grid) x
    (W / grid) windows, in row-major order, holds the tokens at (i H / grid
    + a, j W / grid + b), i, j < grid, row-major in (i, j): each window
    spreads over the whole map."""
    B, H, W, C = x.shape
    x = x.reshape(B, grid, H // grid, grid, W // grid, C).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(B, (H // grid) * (W // grid), grid * grid, C)


def grid_reverse(x: torch.Tensor, grid: int, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`grid_partition`."""
    B, _, _, C = x.shape
    x = x.reshape(B, H // grid, W // grid, grid, grid, C).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(B, H, W, C)


def to_order(x: torch.Tensor, order: Order) -> torch.Tensor:
    """(B, H, W, C) -> ``order``'s layout: rolled by (-shift, -shift), then
    :func:`window_partition`; or :func:`grid_partition`."""
    if order is None:
        return x
    window, shift = order
    if shift == GRID:
        return grid_partition(x, window)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    return window_partition(x, window)


def from_order(x: torch.Tensor, order: Order, H: int, W: int) -> torch.Tensor:
    """The inverse of :func:`to_order` onto an H x W map."""
    if order is None:
        return x
    window, shift = order
    if shift == GRID:
        return grid_reverse(x, window, H, W)
    x = window_reverse(x, window, H, W)
    return torch.roll(x, (shift, shift), (1, 2)) if shift else x


def _ordered_shape(shape: torch.Size, order: Order) -> tuple:
    B, H, W, C = shape
    if order is None:
        return (B, H, W, C)
    return (B, (H // order[0]) * (W // order[0]), order[0] ** 2, C)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           branch: Optional[torch.Tensor], branch_order: Order, out_order: Order) -> None:
    """Raises a ValueError on operands the kernels do not take, on every
    device: x not (B, H, W, C), gamma or beta not (C,), an order whose
    window does not divide the map or whose shift is not under the window,
    a branch not at its order's shape, operands on two devices. A grid's G
    must divide the map as a window does."""
    if x.dim() != 4:
        raise ValueError(f"add_norm takes a (B, H, W, C) map, got {tuple(x.shape)}")
    _, H, W, C = x.shape
    if weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"gamma and beta must be ({C},), got {tuple(weight.shape)} and "
                         f"{tuple(bias.shape)}")
    for order in (branch_order, out_order):
        if order is not None:
            window, shift = order
            if window < 1 or H % window or W % window or not (shift == GRID
                                                              or 0 <= shift < window):
                raise ValueError(f"order {order} does not fit a {H} x {W} map: the window must "
                                 f"divide it and the shift lie in [0, window) or be GRID")
    if branch is None:
        if branch_order is not None:
            raise ValueError("a branch order without a branch")
    elif tuple(branch.shape) != _ordered_shape(x.shape, branch_order):
        raise ValueError(f"the branch must be {_ordered_shape(x.shape, branch_order)} at order "
                         f"{branch_order}, got {tuple(branch.shape)}")
    if any(t.device != x.device for t in (weight, bias, branch) if t is not None):
        raise ValueError("add_norm's operands are on more than one device")


def add_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, *,
                   branch: Optional[torch.Tensor] = None, branch_order: Order = None,
                   out_order: Order = None, out_dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composition the kernels replace, in plain PyTorch: the add of the
    branch brought back to natural order (roll and window reverse, or grid
    reverse), the layer norm in float32, the roll and window partition (or
    grid partition) to ``out_order``, the cast to ``out_dtype``;
    differentiable. Returns (s, y)."""
    _, H, W, C = x.shape
    s = x if branch is None else x + from_order(branch, branch_order, H, W)
    with torch.autocast(x.device.type, enabled=False):
        y = F.layer_norm(s.float(), (C,), weight.float(), bias.float(), eps)
    return s, to_order(y, out_order).to(out_dtype)


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the kernels read or write it as rows: contiguous, on a
    16-byte boundary (they move 4 channels at a time); otherwise a copy."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _order_args(order: Order) -> Tuple[int, int]:
    return (0, 0) if order is None else order


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, C: int) -> int:
    return query("swin_norm", "swin_norm_bwd_blocks_per_sm", torch.device("cuda", device_index),
                 C)


def _bwd_blocks(device: torch.device, C: int) -> int:
    """CTAs of the backward, each one partial of the gamma and beta
    gradients: as many as the card holds at once."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return _blocks_per_sm(index, C) * sm_count(device)


def _dtypes(x_dtype: torch.dtype, branch_dtype: Optional[torch.dtype],
            out_dtype: torch.dtype) -> int:
    """csrc/swin_norm.cu's ``dtypes`` bits: which of x, the branch and y are
    bf16."""
    bf = torch.bfloat16
    return ((_X_BF16 if x_dtype == bf else 0) | (_BRANCH_BF16 if branch_dtype == bf else 0)
            | (_OUT_BF16 if out_dtype == bf else 0))


def forward(x, weight, bias, eps, branch, branch_order, out_order, out_dtype):
    """One forward launch on checked CUDA operands (rows as :func:`_rows`
    gives them, float32 gamma and beta): y, the sum (None without a
    branch) and the rows' (mean, rstd), (rows, 2) float32."""
    B, H, W, C = x.shape
    rows = B * H * W
    s = None
    if branch is not None:
        s = torch.empty(x.shape, dtype=torch.promote_types(x.dtype, branch.dtype),
                        device=x.device)
    y = torch.empty(_ordered_shape(x.shape, out_order), dtype=out_dtype, device=x.device)
    stats = torch.empty((rows, 2), dtype=torch.float32, device=x.device)
    dtypes = _dtypes(x.dtype, None if branch is None else branch.dtype, out_dtype)
    launch("swin_norm", "swin_norm_fwd", x.device, x.data_ptr(),
           0 if branch is None else branch.data_ptr(), 0 if s is None else s.data_ptr(),
           y.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows, H, W, C,
           dtypes, *_order_args(branch_order), *_order_args(out_order), eps)
    return y, s, stats


def backward(dy, ds, saved, stats, weight, x_dtype, branch_dtype, branch_order, out_order):
    """One backward launch and its finalize: dx in ``x_dtype``, natural
    order; the branch's gradient at ``branch_order`` in ``branch_dtype``
    (None without a branch); dgamma and dbeta, float32. ``saved`` is the
    forward's sum (x without a branch), ``ds`` its gradient or None."""
    B, H, W, C = saved.shape
    dev = saved.device
    dx = torch.empty(saved.shape, dtype=x_dtype, device=dev)
    dbranch = None
    if branch_dtype is not None:
        dbranch = torch.empty(_ordered_shape(saved.shape, branch_order), dtype=branch_dtype,
                              device=dev)
    nblk = _bwd_blocks(dev, C)
    partial = torch.empty((nblk, 2 * C), dtype=torch.float32, device=dev)
    dgb = torch.empty((2, C), dtype=torch.float32, device=dev)
    dtypes = _dtypes(x_dtype, branch_dtype, dy.dtype)
    launch("swin_norm", "swin_norm_bwd", dev, dy.data_ptr(), 0 if ds is None else ds.data_ptr(),
           saved.data_ptr(), stats.data_ptr(), weight.data_ptr(), dx.data_ptr(),
           0 if dbranch is None else dbranch.data_ptr(), partial.data_ptr(), dgb.data_ptr(),
           B * H * W, H, W, C, dtypes, *_order_args(branch_order), *_order_args(out_order), nblk)
    return dx, dbranch, dgb[0], dgb[1]


class _AddNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, branch, eps, branch_order, out_order, out_dtype):
        x = _rows(x)
        branch = None if branch is None else _rows(branch)
        w32, b32 = (_rows(t.float()) for t in (weight, bias))
        y, s, stats = forward(x, w32, b32, eps, branch, branch_order, out_order, out_dtype)
        ctx.save_for_backward(x if s is None else s, stats, w32)
        ctx.meta = (x.dtype, None if branch is None else branch.dtype, weight.dtype,
                    branch_order, out_order, out_dtype)
        ctx.set_materialize_grads(False)
        return (x if s is None else s), y

    @staticmethod
    def backward(ctx, ds, dy):
        saved, stats, w32 = ctx.saved_tensors
        x_dtype, branch_dtype, w_dtype, branch_order, out_order, out_dtype = ctx.meta
        if dy is None:
            dy = torch.zeros(_ordered_shape(saved.shape, out_order), dtype=out_dtype,
                             device=saved.device)
        dx, dbranch, dgamma, dbeta = backward(
            _rows(dy), None if ds is None else _rows(ds), saved, stats, w32, x_dtype,
            branch_dtype, branch_order, out_order)
        return (dx, dgamma.to(w_dtype), dbeta.to(w_dtype), dbranch, None, None, None, None)


def add_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float, *,
             branch: Optional[torch.Tensor] = None, branch_order: Order = None,
             out_order: Order = None, out_dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, y)``: the residual stream ``s = x [+ branch]`` (the branch at
    ``branch_order``), natural order, and ``y = layer_norm(s)`` over the
    last dim at ``out_order`` in ``out_dtype``. The plain version on the
    CPU, the kernels on the card (float32 or bf16 x, branch and y; C a
    multiple of 4 up to 4096); differentiable in x, gamma, beta and the
    branch either way, the gradients of s and y summed into x's."""
    _check(x, weight, bias, branch, branch_order, out_order)
    if not on_card(x, "add_norm"):
        return add_norm_plain(x, weight, bias, eps, branch=branch, branch_order=branch_order,
                              out_order=out_order, out_dtype=out_dtype)
    C = x.shape[-1]
    if C % 4 or C > MAX_C:
        raise ValueError(f"add_norm on the card takes C a multiple of 4 up to {MAX_C}, got {C}")
    dtypes = [x.dtype, out_dtype] + ([] if branch is None else [branch.dtype])
    if any(d not in _DTYPES for d in dtypes):
        raise ValueError(f"add_norm on the card takes float32 or bfloat16, got {dtypes}")
    return _AddNorm.apply(x, weight, bias, branch, eps, branch_order, out_order, out_dtype)
