"""Additive secret sharing over Z_{2^64} with a leading party axis.

Port of ``primia_tpu/mpc/shares.py``: both parties' shares are stacked on
a leading axis, ``(2, *shape)`` int64, so every linear op is one tensor op
over both parties, and an opening is a sum over the party axis.

Randomness comes from an explicit ``torch.Generator`` on the shares'
device. ``Tensor.random_()`` on int64 covers only [0, 2^63), so a ring
element is two 32-bit draws joined: ``lo | hi << 32``.

Party-split sharings (``party_devices`` of ``mpc/inference.py`` and
``mpc/aggregation.py``; the JAX package's ``party_sharding``): the data
of a sharing is then a :class:`Parties`, its two halves each on its
party's device. The same protocol code runs on it: a local op is one op
a half, a public operand is copied to each half's device, and the two
halves meet only in an opening (:func:`reconstruct`), which sends both
to the opener's device (:func:`send`). The dealer draws on its own
device, in the order of the unsplit path, and :func:`deliver` hands each
party its half of the dealer's ``(2, ...)`` material, so a split run is
bit for bit the unsplit one.
"""

from __future__ import annotations

import operator
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

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


class Parties:
    """A ``(2, *shape)`` sharing's data as its two halves, ``halves[p]`` on
    party p's device; ``home`` is where openings land (the dealer's and
    the data owner's device).

    It answers the tensor calls that the protocols make on share data:
    indexing a party (``d[0]``), slicing the value axes (``d[:, i]``,
    ``d[..., a:b]``), ``+ - * %`` and negation with halves or public
    tensors, and ``reshape``, ``expand``, ``sum``, ``transpose``,
    ``unbind``, ``unfold``, ``torch.stack``, ``torch.cumsum`` and
    ``F.pad`` over the value axes. A call that would mix the parties (a
    reduction over the party axis, an op it does not know) raises."""

    __slots__ = ("halves", "home")

    def __init__(self, h0: torch.Tensor, h1: torch.Tensor, home):
        if h0.shape != h1.shape:
            raise ValueError(f"party halves {tuple(h0.shape)} and {tuple(h1.shape)} differ")
        self.halves = [h0, h1]
        self.home = torch.device(home)

    @property
    def shape(self) -> torch.Size:
        return torch.Size((N_PARTIES, *self.halves[0].shape))

    @property
    def ndim(self) -> int:
        return self.halves[0].dim() + 1

    def dim(self) -> int:
        return self.ndim

    def _map(self, fn: Callable) -> "Parties":
        return Parties(fn(self.halves[0]), fn(self.halves[1]), self.home)

    def _value_dim(self, d: int) -> int:
        """A dim of the (2, ...) view as a dim of a half."""
        if d == 0 or d == -self.ndim:
            raise TypeError("an op over the party axis of a party-split sharing")
        return d - 1 if d > 0 else d

    def __getitem__(self, idx):
        if isinstance(idx, int):
            return self.halves[idx]
        if isinstance(idx, tuple) and idx and idx[0] is Ellipsis:
            return self._map(lambda h: h[idx])
        if isinstance(idx, tuple) and idx and idx[0] == slice(None):
            return self._map(lambda h: h[idx[1:]])
        raise TypeError(f"index {idx!r} of a party-split sharing")

    def __setitem__(self, idx, value):
        if not isinstance(idx, int):
            raise TypeError(f"index {idx!r} of a party-split sharing")
        self.halves[idx] = value

    @staticmethod
    def _shape(shape):
        shape = tuple(shape[0]) if len(shape) == 1 and not isinstance(shape[0], int) else shape
        if shape[0] != N_PARTIES:
            raise TypeError(f"shape {shape} of a party-split sharing")
        return shape[1:]

    def reshape(self, *shape) -> "Parties":
        v = self._shape(shape)
        return self._map(lambda h: h.reshape(v))

    def expand(self, *shape) -> "Parties":
        v = self._shape(shape)
        return self._map(lambda h: h.expand(v))

    def sum(self, dim, keepdim: bool = False) -> "Parties":
        d = tuple(map(self._value_dim, dim)) if isinstance(dim, tuple) else self._value_dim(dim)
        return self._map(lambda h: h.sum(d, keepdim=keepdim))

    def transpose(self, a: int, b: int) -> "Parties":
        a, b = self._value_dim(a), self._value_dim(b)
        return self._map(lambda h: h.transpose(a, b))

    def unbind(self, dim: int):
        d = self._value_dim(dim)
        return [Parties(a, b, self.home)
                for a, b in zip(self.halves[0].unbind(d), self.halves[1].unbind(d))]

    def unfold(self, dim: int, size: int, step: int) -> "Parties":
        d = self._value_dim(dim)
        return self._map(lambda h: h.unfold(d, size, step))

    def clone(self) -> "Parties":
        return self._map(torch.clone)

    def contiguous(self) -> "Parties":
        return self._map(lambda h: h.contiguous())

    def to(self, dtype: torch.dtype) -> "Parties":
        return self._map(lambda h: h.to(dtype))

    # ---- elementwise: one op a half, public operands copied to its device
    @staticmethod
    def _elementwise(op, *args):
        home = next(a.home for a in args if isinstance(a, Parties))

        def operand(a, p, ref):
            if isinstance(a, Parties):
                return a.halves[p]
            if isinstance(a, torch.Tensor):
                if a.dim() > ref.dim():
                    raise TypeError(f"a public operand {tuple(a.shape)} with more dims than "
                                    f"the sharing's value {tuple(ref.shape)}: deliver the "
                                    f"dealer's (2, ...) material first")
                return public_on(a, ref)
            return a

        ref = [next(a.halves[p] for a in args if isinstance(a, Parties)) for p in (0, 1)]
        return Parties(*(op(*(operand(a, p, ref[p]) for a in args)) for p in (0, 1)), home)

    def __add__(self, other):
        return Parties._elementwise(operator.add, self, other)

    def __sub__(self, other):
        return Parties._elementwise(operator.sub, self, other)

    def __mul__(self, other):
        return Parties._elementwise(operator.mul, self, other)

    def __mod__(self, other):
        return Parties._elementwise(operator.mod, self, other)

    def __neg__(self) -> "Parties":
        return self._map(operator.neg)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.stack:
            seq = list(args[0])
            dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
            like = next(a for a in seq if isinstance(a, Parties))
            d = like._value_dim(dim) if dim >= 0 else dim
            return Parties(*(torch.stack([a.halves[p] for a in seq], d) for p in (0, 1)),
                           like.home)
        if func is F.pad:
            return args[0]._map(lambda h: F.pad(h, *args[1:], **kwargs))
        if func is torch.cumsum:
            d = args[0]._value_dim(kwargs.pop("dim", args[1] if len(args) > 1 else None))
            return args[0]._map(lambda h: torch.cumsum(h, d, **kwargs))
        # a public tensor on the left of + - *
        if getattr(func, "__name__", None) in ("add", "sub", "mul") and not kwargs:
            return cls._elementwise(func, *args)
        raise TypeError(f"{getattr(func, '__name__', func)} on a party-split sharing")


def public_on(t, like: torch.Tensor):
    """A public operand where a party's half ``like`` lives (a no-op on its
    device; Python numbers as they are)."""
    return t.to(like.device) if isinstance(t, torch.Tensor) else t


def send(half: torch.Tensor, device) -> torch.Tensor:
    """A party's share half sent to ``device`` for an opening: the only
    place a share leaves its party."""
    return half.to(device)


def split(data: torch.Tensor, devices, home) -> Parties:
    """Shares made on one device, ``(2, ...)``, split: party p's half to
    ``devices[p]``."""
    return Parties(data[0].to(devices[0]), data[1].to(devices[1]), home)


def deliver(material: torch.Tensor, like):
    """The dealer's ``(2, ...)`` material for the parties that hold
    ``like`` (a sharing's data): each party's half sent to its device when
    they are split, else the material as it is."""
    if isinstance(like, Parties):
        return Parties(material[0].to(like.halves[0].device),
                       material[1].to(like.halves[1].device), like.home)
    return material


def join(like, h0: torch.Tensor, h1: torch.Tensor):
    """Each party's new half, as ``like``'s data is held: stacked on one
    device, or split."""
    if isinstance(like, Parties):
        return Parties(h0, h1, like.home)
    return torch.stack([h0, h1])


def party_devices_of(devices) -> Optional[tuple]:
    """``party_devices`` as a pair of ``torch.device`` (None stays None)."""
    if devices is None:
        return None
    if len(devices) != N_PARTIES:
        raise ValueError(f"party_devices needs {N_PARTIES} devices, got {devices!r}")
    return tuple(torch.device(d) for d in devices)


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
    """Open a sharing: the sum over the party axis. A party-split sharing
    is opened on its ``home`` device, to which both parties send their
    halves."""
    d = x.data
    if isinstance(d, Parties):
        return send(d.halves[0], d.home) + send(d.halves[1], d.home)
    return d.sum(0)


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
    d[0] += public_on(c, d[0])
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
