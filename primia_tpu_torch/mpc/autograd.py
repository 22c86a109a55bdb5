"""Autograd over secret shares: encrypted training.

Port of ``primia_tpu/mpc/autograd.py``: a small reverse-mode tape over
``AShare`` values. Every op records a share-space VJP, so data,
activations, weights and gradients stay shared through the whole step;
since weights and activations are both private, every product of the
backward pass is itself a Beaver product.

Layout: activations NCHW ``(2, B, C, H, W)``, conv weights OIHW, linear
weights PyTorch's ``(out, in)`` (``y = x @ w^T + b``), as the rest of the
port. Every dealer draw comes from the context's generator
(``ctx.gen``), in the order the ops and their VJPs run. ``relu`` is one
private comparison by the context's protocol (under ``fss`` on a CUDA
tensor, kernel K4 through ``compare.sign_shares``); its positive mask is
reused by the backward pass. Example:

    loss, grads = value_and_grad(forward)(ctx, param_shares, x_share, y_share)
    new = {k: sgd_update(v, grads[k], lr, ctx.frac_bits) for k, v in param_shares.items()}
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch

from primia_tpu_torch.mpc import beaver, fixed, ring_ops
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.engine import MpcContext
from primia_tpu_torch.mpc.shares import AShare


class Var:
    """A share-space tensor tracked by the tape."""

    __slots__ = ("value", "parents", "vjp")

    def __init__(self, value: AShare, parents: Tuple["Var", ...] = (),
                 vjp: Optional[Callable] = None):
        self.value = value
        self.parents = parents
        self.vjp = vjp  # grad_out -> tuple of parent grads (AShare or None)

    @property
    def shape(self):
        return self.value.shape


def backward(root: Var, seed_grad: AShare) -> Dict[int, AShare]:
    """Reverse topological sweep; returns {id(var): grad share} for every
    node of the tape (callers look up their leaves)."""
    order: List[Var] = []
    seen = set()
    stack = [(root, False)]
    while stack:  # iterative post-order: a long RNN tape is deep
        v, done = stack.pop()
        if done:
            order.append(v)
        elif id(v) not in seen:
            seen.add(id(v))
            stack.append((v, True))
            stack.extend((p, False) for p in reversed(v.parents))
    grads: Dict[int, AShare] = {id(root): seed_grad}
    for v in reversed(order):
        g = grads.get(id(v))
        if g is None or v.vjp is None:
            continue
        for parent, pg in zip(v.parents, v.vjp(g)):
            if pg is not None:
                prev = grads.get(id(parent))
                grads[id(parent)] = pg if prev is None else S.add(prev, pg)
    return grads


def _truncate(ctx: MpcContext, z: AShare) -> AShare:
    return AShare(fixed.truncate_shares(z.data, ctx.frac_bits))


# ---------------------------------------------------------------- ops

def add(x: Var, y: Var) -> Var:
    return Var(S.add(x.value, y.value), (x, y), lambda g: (g, g))


def sub(x: Var, y: Var) -> Var:
    return Var(S.sub(x.value, y.value), (x, y), lambda g: (g, S.neg(g)))


def mul(ctx: MpcContext, x: Var, y: Var) -> Var:
    """Elementwise private product of equal shapes (both grads are Beaver
    products)."""
    out = _truncate(ctx, beaver.mul(ctx.gen, x.value, y.value))

    def vjp(g):
        gx = _truncate(ctx, beaver.mul(ctx.gen, g, y.value))
        gy = _truncate(ctx, beaver.mul(ctx.gen, g, x.value))
        return gx, gy

    return Var(out, (x, y), vjp)


def _matmul(ctx: MpcContext, a: AShare, b: AShare, ta: bool = False, tb: bool = False) -> AShare:
    """Beaver matmul with optional local transposes, truncated."""
    av = AShare(a.data.transpose(-1, -2)) if ta else a
    bv = AShare(b.data.transpose(-1, -2)) if tb else b
    return _truncate(ctx, beaver.matmul(ctx.gen, av, bv))


def linear(ctx: MpcContext, x: Var, w: Var, b: Optional[Var] = None) -> Var:
    """y = x @ w^T (+ b); x (B, in), w (out, in)."""
    y = _matmul(ctx, x.value, w.value, tb=True)
    if b is not None:
        y = AShare(y.data + b.value.data.reshape(2, 1, -1))

    def vjp(g):
        gx = _matmul(ctx, g, w.value)  # g @ w
        gw = _matmul(ctx, g, x.value, ta=True)  # g^T @ x
        return (gx, gw) if b is None else (gx, gw, AShare(g.data.sum(1)))

    return Var(y, (x, w) if b is None else (x, w, b), vjp)


def conv_vjp_fns(x_shape, w_shape, stride: int, padding: int):
    """The two bilinear ring convs of ``conv2d``'s VJP for an NCHW input of
    ``x_shape`` and OIHW weights of ``w_shape``: ``(f_gx(g, w), f_gw(x,
    g))``, the input and the weight gradient."""
    kh, kw = w_shape[2], w_shape[3]
    H, W = x_shape[2], x_shape[3]
    # when (dim + 2p - k) % stride != 0 the forward conv drops a partial
    # window; the gradient convs account for the remainder
    rem_h = (H + 2 * padding - kh) % stride
    rem_w = (W + 2 * padding - kw) % stride

    def f_gx(gd, wd):
        # the conv of the stride-dilated g with the spatially flipped
        # kernel, its in and out channels swapped
        return ring_ops.ring_conv_general(
            gd, wd.flip(2, 3).transpose(0, 1),
            padding=((kh - 1 - padding, kh - 1 - padding + rem_h),
                     (kw - 1 - padding, kw - 1 - padding + rem_w)),
            lhs_dilation=(stride, stride))

    def f_gw(xd, gd):
        # a contraction over batch and output pixels: x as (C_in, B, H, W)
        # images, g as (C_out, B, Ho, Wo) kernels dilated by the stride;
        # (C_in, C_out, kh + rem, kw + rem) -> OIHW, sliced to the kernel
        # when a partial window remains
        r = ring_ops.ring_conv_general(
            xd.transpose(0, 1), gd.transpose(0, 1),
            padding=((padding, padding), (padding, padding)),
            rhs_dilation=(stride, stride))
        return r.transpose(0, 1)[..., :kh, :kw].contiguous()

    return f_gx, f_gw


def conv2d(ctx: MpcContext, x: Var, w: Var, stride: int = 1, padding: int = 0) -> Var:
    """NCHW x OIHW share-space conv with share-space gradients."""
    out = _truncate(ctx, beaver.conv2d(ctx.gen, x.value, w.value, stride, padding))
    f_gx, f_gw = conv_vjp_fns(x.shape, w.shape, stride, padding)

    def vjp(g):
        t = beaver.gen_triple(ctx.gen, f_gx, g.shape, w.shape)
        gx = _truncate(ctx, beaver.bilinear(f_gx, g, w.value, t))
        t2 = beaver.gen_triple(ctx.gen, f_gw, x.shape, g.shape)
        gw = _truncate(ctx, beaver.bilinear(f_gw, x.value, g, t2))
        return gx, gw

    return Var(out, (x, w), vjp)


def _channel_shape(x: AShare, n: int):
    """A (C,) vector on x's channel axis (1), with the party axis."""
    return (2, 1, n) + (1,) * (x.ndim - 2)


def bias_add(x: Var, b: Var) -> Var:
    """Channelwise bias on NCHW (or (B, C)) activations."""
    bd = b.value.data.reshape(_channel_shape(x.value, b.shape[0]))

    def vjp(g):
        axes = (1,) + tuple(range(3, g.data.dim()))
        return g, AShare(g.data.sum(axes))

    return Var(AShare(x.value.data + bd), (x, b), vjp)


def relu(ctx: MpcContext, x: Var) -> Var:
    """One private comparison; the positive mask's shares are reused by
    the backward pass."""
    pos = S.add_public(S.neg(ctx.sign_shares(x.value)), 1)  # shares of 1{x >= 0}
    y = beaver.mul(ctx.gen, x.value, pos)  # a bit product: no truncation

    def vjp(g):
        return (beaver.mul(ctx.gen, g, pos),)

    return Var(y, (x,), vjp)


def avg_pool(ctx: MpcContext, x: Var, window: int, stride: Optional[int] = None) -> Var:
    """Non-overlapping average pool (stride defaults to the window): the
    window sums by reshape and sum (int64 pooling is not a CUDA op), times
    ``encode(1 / w^2)``, truncated."""
    stride = stride or window
    if stride != window:
        raise NotImplementedError("encrypted avg_pool is non-overlapping")
    d = x.value.data
    _, B, C, H, W = d.shape
    Ho, Wo = H // window, W // window
    inv = int(fixed.encode(1.0 / (window * window), ctx.frac_bits))
    summed = d[..., :Ho * window, :Wo * window].reshape(
        2, B, C, Ho, window, Wo, window).sum((4, 6))
    out = _truncate(ctx, AShare(summed * inv))

    def vjp(g):
        scaled = fixed.truncate_shares(g.data * inv, ctx.frac_bits)
        up = scaled.repeat_interleave(window, 3).repeat_interleave(window, 4)
        # VALID pooling drops partial windows; those inputs get zero gradient
        up = torch.nn.functional.pad(up, (0, W - up.shape[4], 0, H - up.shape[3]))
        return (AShare(up),)

    return Var(out, (x,), vjp)


def flatten(x: Var) -> Var:
    shp = x.shape

    def vjp(g):
        return (AShare(g.data.reshape(2, *shp)),)

    return Var(S.reshape(x.value, (shp[0], -1)), (x,), vjp)


def mse_loss(ctx: MpcContext, pred: Var, target: AShare) -> Tuple[Var, AShare]:
    """Mean squared error over all elements; returns (loss var, loss
    share). ``backward(loss_var, seed)`` expects the seed ``encode(1.0)``,
    d(loss)/d(loss) = 1."""
    n = pred.value.data[0].numel()
    diff = S.sub(pred.value, target)
    sq = beaver.mul(ctx.gen, diff, diff)
    total = sq.data.reshape(2, -1).sum(1)
    inv_n = int(fixed.encode(1.0 / n, ctx.frac_bits))
    # two scale-downs pending: the product's frac_bits and the 1 / n
    loss = AShare(fixed.truncate_shares(
        fixed.truncate_shares(total * inv_n, ctx.frac_bits), ctx.frac_bits))
    two_over_n = int(fixed.encode(2.0 / n, ctx.frac_bits))

    def vjp(g):
        # g is ~encode(1); d loss / d pred = 2 / n * diff (a public scale)
        return (AShare(fixed.truncate_shares(diff.data * two_over_n, ctx.frac_bits)),)

    return Var(loss, (pred,), vjp), loss


def value_and_grad(forward: Callable):
    """``forward(ctx, params: dict[str, Var], *args) -> (loss_var, loss)``
    becomes ``f(ctx, param_shares, *args) -> (loss share, grads dict)``."""

    def f(ctx: MpcContext, param_shares: Dict[str, AShare], *args):
        pvars = {k: Var(v) for k, v in param_shares.items()}
        loss_var, loss_share = forward(ctx, pvars, *args)
        one = loss_var.value.data.new_full(loss_var.shape, int(fixed.encode(1.0, ctx.frac_bits)))
        grads = backward(loss_var, S.share(ctx.gen, one))
        gdict = {k: grads.get(id(v), S.zeros_like(v.value)) for k, v in pvars.items()}
        return loss_share, gdict

    return f


def sgd_update(w: AShare, g: AShare, lr: float,
               frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> AShare:
    """w - lr * g entirely in share space (a public lr)."""
    step = fixed.truncate_shares(g.data * int(fixed.encode(lr, frac_bits)), frac_bits)
    return AShare(w.data - step)
