"""Additive secret sharing over Z_{2^64} with a leading party axis.

Port of ``primia_tpu/mpc/shares.py``: both parties' shares are stacked on
a leading axis, ``(2, *shape)`` int64, so every linear op is one tensor op
over both parties, and an opening is a sum over the party axis.

Randomness comes from an explicit ``torch.Generator`` on the shares'
device. ``Tensor.random_()`` on int64 covers only [0, 2^63), so a ring
element is two 32-bit draws joined: ``lo | hi << 32``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

N_PARTIES = 2


class AShare(NamedTuple):
    """(2, *shape) int64 additive sharing; x = sum over axis 0 (mod 2^64)."""

    data: torch.Tensor

    @property
    def shape(self):
        return self.data.shape[1:]

    @property
    def ndim(self) -> int:
        return self.data.dim() - 1


def stream(device, *path: int) -> torch.Generator:
    """An independent generator on ``device`` for the stream ``path`` (a
    tuple of integers, as a JAX key is folded: seed, purpose, round, ...)."""
    s = int(np.random.SeedSequence(list(path)).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(s)


def rand_ring(gen: torch.Generator, shape) -> torch.Tensor:
    """Uniform ring elements over all of Z_{2^64}, on ``gen``'s device."""
    words = torch.randint(0, 1 << 32, (2, *shape), dtype=torch.int64, generator=gen,
                          device=gen.device)
    return words[0] | (words[1] << 32)


def share(gen: torch.Generator, value: torch.Tensor) -> AShare:
    """Split a ring value into two additive shares: ``(value - r, r)``."""
    r = rand_ring(gen, value.shape)
    return AShare(torch.stack([value - r, r]))


def make_public(value: torch.Tensor) -> AShare:
    """The trivial sharing of a public ring value: party 0 holds it all."""
    return AShare(torch.stack([value, torch.zeros_like(value)]))


def reconstruct(x: AShare) -> torch.Tensor:
    """Open a sharing: the sum over the party axis."""
    return x.data.sum(0)


def zeros_like(x: AShare) -> AShare:
    return AShare(torch.zeros_like(x.data))


def add(x: AShare, y: AShare) -> AShare:
    return AShare(x.data + y.data)


def sub(x: AShare, y: AShare) -> AShare:
    return AShare(x.data - y.data)


def neg(x: AShare) -> AShare:
    return AShare(-x.data)


def add_public(x: AShare, c) -> AShare:
    """x + public c: only party 0 offsets its share."""
    d = x.data.clone()
    d[0] += c
    return AShare(d)


def mul_public(x: AShare, c) -> AShare:
    """x * public integer c (a Python int or an int64 tensor that
    broadcasts against x): both parties scale their shares."""
    return AShare(x.data * c)


def stack(shares: Sequence[AShare], axis: int = 0) -> AShare:
    """Stack equal-shape sharings along a new value axis."""
    return AShare(torch.stack([s.data for s in shares], dim=axis + 1))


def reshape(x: AShare, shape) -> AShare:
    return AShare(x.data.reshape(N_PARTIES, *shape))
