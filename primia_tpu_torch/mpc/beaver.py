"""Beaver-triple products over additive shares: elementwise, matmul, conv.

Port of ``primia_tpu/mpc/beaver.py``. The dealer draws random ``a``, ``b``
and computes ``c = f(a, b)`` in the ring, all three shared; online, the
parties open ``delta = x - a`` and ``eps = y - b`` and combine

    z = c + f(delta, b) + f(a, eps),   party 0 adds f(delta, eps).

The JAX package maps ``f`` over the party axis with ``jax.vmap``. Here
the party axis is written out: for a matmul or a conv, ``delta`` against
both parties' ``b`` and against ``eps`` is one product with the three
right operands stacked on the output axis, and both parties' ``a``
against ``eps`` one product with the party axis folded into the rows (or
the batch). The dealer is simulated from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from primia_tpu_torch.mpc import ring_ops
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare


class Triple(NamedTuple):
    a: AShare
    b: AShare
    c: AShare


def gen_triple(gen: torch.Generator, f: Callable, a_shape, b_shape) -> Triple:
    """Dealer: random a, b; c = f(a, b) in the ring; all three shared."""
    a = S.rand_ring(gen, a_shape)
    b = S.rand_ring(gen, b_shape)
    c = f(a, b)
    return Triple(S.share(gen, a), S.share(gen, b), S.share(gen, c))


def _open(x: AShare, y: AShare, t: Triple):
    return S.reconstruct(S.sub(x, t.a)), S.reconstruct(S.sub(y, t.b))


def mul(gen: torch.Generator, x: AShare, y: AShare) -> AShare:
    """Elementwise product of two sharings of one shape."""
    t = gen_triple(gen, torch.mul, x.shape, y.shape)
    delta, eps = _open(x, y, t)
    z = t.c.data + delta * t.b.data + t.a.data * eps
    z[0] += delta * eps
    return AShare(z)


def matmul(gen: torch.Generator, x: AShare, y: AShare) -> AShare:
    """(M, K) @ (K, N) on sharings."""
    f = ring_ops.ring_matmul
    t = gen_triple(gen, f, x.shape, y.shape)
    delta, eps = _open(x, y, t)
    M, N = x.shape[0], y.shape[1]
    d = f(delta, torch.cat([t.b.data[0], t.b.data[1], eps], dim=1)).reshape(M, 3, N)
    ae = f(t.a.data.reshape(2 * M, -1), eps).reshape(2, M, N)
    z = t.c.data + d[:, :2].permute(1, 0, 2) + ae
    z[0] += d[:, 2]
    return AShare(z)


def conv2d(gen: torch.Generator, x: AShare, w: AShare, stride: int, padding: int) -> AShare:
    """NCHW x OIHW convolution on sharings."""
    f = lambda a, b: ring_ops.ring_conv2d(a, b, stride, padding)  # noqa: E731
    t = gen_triple(gen, f, x.shape, w.shape)
    delta, eps = _open(x, w, t)
    B, O = x.shape[0], w.shape[0]
    d = f(delta, torch.cat([t.b.data[0], t.b.data[1], eps]))
    d = d.reshape(B, 3, O, *d.shape[2:])
    ae = f(t.a.data.flatten(0, 1), eps)
    ae = ae.reshape(2, B, *ae.shape[1:])
    z = t.c.data + d[:, :2].transpose(0, 1) + ae
    z[0] += d[:, 2]
    return AShare(z)
