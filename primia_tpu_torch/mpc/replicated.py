"""Replicated secret sharing: 3 parties, falcon-style, honest majority.

Port of ``primia_tpu/mpc/replicated.py``. x = x_0 + x_1 + x_2 (mod 2^64)
and party i holds the pair (x_i, x_{i+1}), as one int64 tensor with the
leading axes ``(3, 2, ...)``: the party, then the slot. Every local op is
one tensor op over all parties and slots. A private product is one
round: each party's three cross terms form a 3-of-3 sharing of the
product, masked with PRZS zero shares (``mpc/przs.py``) and rolled along
the party axis to rebuild the pairs (the reshare). Randomness comes from
the caller's ``torch.Generator``, drawn in the JAX package's order (the
two masks of :func:`share`; the ring's three streams of a reshare).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from primia_tpu_torch.mpc import fixed, przs, ring_ops
from primia_tpu_torch.mpc import shares as S

N_PARTIES = 3


class RShare(NamedTuple):
    """(3, 2, *shape) int64: party i holds (x_i, x_{i+1 mod 3})."""

    data: torch.Tensor

    @property
    def shape(self):
        return self.data.shape[2:]


def _replicate(parts: torch.Tensor) -> RShare:
    """(3, *shape) additive parts -> the replicated layout (each party
    also holds its successor's part)."""
    return RShare(torch.stack([parts, parts.roll(-1, dims=0)], dim=1))


def share(gen: torch.Generator, value: torch.Tensor) -> RShare:
    """Split a ring value into 3 parts and hand out the pairs."""
    r1 = S.rand_ring(gen, value.shape)
    r2 = S.rand_ring(gen, value.shape)
    return _replicate(torch.stack([r1, r2, value - r1 - r2]))


def reconstruct(x: RShare) -> torch.Tensor:
    """Open from any two parties: party 0's pair and party 1's second slot
    are (x_0, x_1, x_2)."""
    return x.data[0, 0] + x.data[0, 1] + x.data[1, 1]


def add(x: RShare, y: RShare) -> RShare:
    return RShare(x.data + y.data)


def sub(x: RShare, y: RShare) -> RShare:
    return RShare(x.data - y.data)


def neg(x: RShare) -> RShare:
    return RShare(-x.data)


def add_public(x: RShare, c) -> RShare:
    """x + public c: only the part x_0 moves, which party 0 holds in slot
    0 and party 2 in slot 1."""
    d = x.data.clone()
    d[0, 0] += c
    d[2, 1] += c
    return RShare(d)


def mul_public(x: RShare, c) -> RShare:
    return RShare(x.data * c)


def _reshare(gen: torch.Generator, z: torch.Tensor) -> RShare:
    """A (3, ...) 3-of-3 sharing masked with PRZS zero shares, then
    replicated (the one round of communication)."""
    return _replicate(z + przs.zero_shares(przs.setup(gen, N_PARTIES), z.shape[1:]))


def _mul_core(gen: torch.Generator, x: RShare, y: RShare, f) -> RShare:
    """Party i computes f(x_i, y_i) + f(x_i, y_{i+1}) + f(x_{i+1}, y_i):
    over the three parties each of the nine cross terms of the product
    appears once. ``f`` runs on each party's operands in turn."""
    xd, yd = x.data, y.data
    z = torch.stack([f(xd[i, 0], yd[i, 0]) + f(xd[i, 0], yd[i, 1]) + f(xd[i, 1], yd[i, 0])
                     for i in range(N_PARTIES)])
    return _reshare(gen, z)


def mul(gen: torch.Generator, x: RShare, y: RShare) -> RShare:
    """Elementwise private product of equal shapes: one round, no triple."""
    return _mul_core(gen, x, y, torch.mul)


def matmul(gen: torch.Generator, x: RShare, y: RShare) -> RShare:
    """(M, K) @ (K, N) private product (``ring_ops.ring_matmul``)."""
    return _mul_core(gen, x, y, ring_ops.ring_matmul)


def truncate(gen: torch.Generator, x: RShare,
             frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> RShare:
    """The fixed-point rescale after a product: a 2-of-2 split (parts 0 +
    1 against part 2), each side truncated as SecureML does, re-randomised,
    re-split. Error <= 1 ulp for |x| << 2^(63 - frac_bits), as
    ``fixed.truncate_shares``.

    The PRZS re-randomisation is load-bearing for secrecy: without it the
    3-of-3 vector is (t0, 0, t1), and party 2's pair (x_2, x_0) = (t1, t0)
    would be the whole 2-of-2 sharing, which one party could open."""
    parts = torch.stack([x.data[0, 0] + x.data[1, 0], x.data[2, 0]])
    t = fixed.truncate_shares(parts, frac_bits)
    return _reshare(gen, torch.stack([t[0], torch.zeros_like(t[0]), t[1]]))
