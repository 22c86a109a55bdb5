"""Beaver-triple products over additive shares: elementwise, matmul, conv.

Port of ``primia_tpu/mpc/beaver.py``. The dealer draws random ``a``, ``b``
and computes ``c = f(a, b)`` in the ring, all three shared; online, the
parties open ``delta = x - a`` and ``eps = y - b`` and combine

    z = c + f(delta, b) + f(a, eps),   party 0 adds f(delta, eps).

The JAX package maps ``f`` over the party axis with ``jax.vmap``. Here
the party axis is written out. :func:`bilinear` is the general combine,
five calls of ``f`` for any bilinear ``f`` (the share-space gradients'
convolutions). For a matmul or a conv, ``delta`` against
both parties' ``b`` and against ``eps`` is one product with the three
right operands stacked on the output axis, and both parties' ``a``
against ``eps`` one product with the party axis folded into the rows (or
the batch). The dealer is simulated from a ``torch.Generator``.

Party-split operands (``shares.Parties``): the dealer still draws the
triple on its device, each party receives its half of a, b and c
(``shares.deliver``), delta and eps are opened, and each party forms its
own ``c + f(delta, b) + f(a, eps)`` on its device, party 0 adding
``f(delta, eps)``: two products a party where the unsplit path batches
both parties into one.
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


def _deliver(t: Triple, x: AShare) -> Triple:
    """The triple for the parties that hold x (as it is when unsplit)."""
    return Triple(*(AShare(S.deliver(s.data, x.data)) for s in t))


def _per_party(f: Callable, t: Triple, delta: torch.Tensor, eps: torch.Tensor) -> AShare:
    """z = c + f(delta, b) + f(a, eps) by each party on its own device,
    party 0 adding f(delta, eps): the split form of the combines below."""
    a, b, c = t.a.data, t.b.data, t.c.data
    z = []
    for p in (0, 1):
        dp, ep = S.public_on(delta, b[p]), S.public_on(eps, b[p])
        zp = c[p] + f(dp, b[p]) + f(a[p], ep)
        z.append(zp + f(dp, ep) if p == 0 else zp)
    return AShare(S.Parties(z[0], z[1], a.home))


def bilinear(f: Callable, x: AShare, y: AShare, triple: Triple) -> AShare:
    """z = f(x, y) on sharings through ``triple`` (the online phase), for
    any bilinear ``f`` of two int64 ring tensors: ``delta`` and ``eps``
    are opened; each party's cross terms are ``f`` on its own shares;
    ``f(delta, eps)`` enters party 0's share only."""
    delta, eps = _open(x, y, triple)
    a, b = triple.a.data, triple.b.data
    z = triple.c.data + torch.stack([f(delta, b[0]) + f(a[0], eps),
                                     f(delta, b[1]) + f(a[1], eps)])
    z[0] += f(delta, eps)
    return AShare(z)


def mul(gen: torch.Generator, x: AShare, y: AShare) -> AShare:
    """Elementwise product of two sharings of one shape."""
    t = _deliver(gen_triple(gen, torch.mul, x.shape, y.shape), x)
    delta, eps = _open(x, y, t)
    z = t.c.data + delta * t.b.data + t.a.data * eps
    z[0] += S.public_on(delta * eps, z[0])
    return AShare(z)


def matmul(gen: torch.Generator, x: AShare, y: AShare) -> AShare:
    """(M, K) @ (K, N) on sharings."""
    f = ring_ops.ring_matmul
    t = _deliver(gen_triple(gen, f, x.shape, y.shape), x)
    delta, eps = _open(x, y, t)
    if isinstance(t.a.data, S.Parties):
        return _per_party(f, t, delta, eps)
    M, N = x.shape[0], y.shape[1]
    d = f(delta, torch.cat([t.b.data[0], t.b.data[1], eps], dim=1)).reshape(M, 3, N)
    ae = f(t.a.data.reshape(2 * M, -1), eps).reshape(2, M, N)
    z = t.c.data + d[:, :2].permute(1, 0, 2) + ae
    z[0] += d[:, 2]
    return AShare(z)


def conv2d(gen: torch.Generator, x: AShare, w: AShare, stride: int, padding: int) -> AShare:
    """NCHW x OIHW convolution on sharings."""
    f = lambda a, b: ring_ops.ring_conv2d(a, b, stride, padding)  # noqa: E731
    t = _deliver(gen_triple(gen, f, x.shape, w.shape), x)
    delta, eps = _open(x, w, t)
    if isinstance(t.a.data, S.Parties):
        return _per_party(f, t, delta, eps)
    B, O = x.shape[0], w.shape[0]
    d = f(delta, torch.cat([t.b.data[0], t.b.data[1], eps]))
    d = d.reshape(B, 3, O, *d.shape[2:])
    ae = f(t.a.data.flatten(0, 1), eps)
    ae = ae.reshape(2, B, *ae.shape[1:])
    z = t.c.data + d[:, :2].transpose(0, 1) + ae
    z[0] += d[:, 2]
    return AShare(z)
