"""Fixed-point codec over the ring Z_{2^64}.

Port of ``primia_tpu/mpc/fixed.py``: floats are encoded as
``round(x * 2**frac_bits)`` in int64, whose two's-complement wraparound is
the mod-2^64 ring; base 2, so truncation is an arithmetic shift. Torch's
``round`` rounds half to even, as ``jnp.round`` does, and its ``>>`` on
int64 is arithmetic.
"""

from __future__ import annotations

import torch

DEFAULT_FRAC_BITS = 16


def encode(x, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """float -> ring: round to nearest (half to even) after scaling, in
    float64."""
    x = torch.as_tensor(x)
    return torch.round(x.double() * float(1 << frac_bits)).long()


def decode(v: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """ring -> float64, reading int64 as signed."""
    return v.double() / float(1 << frac_bits)


def truncate_public(v: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """Exact truncation of a public ring value after a product: an
    arithmetic shift, rounding toward -inf."""
    return v >> frac_bits


def truncate_shares(shares: torch.Tensor, frac_bits: int = DEFAULT_FRAC_BITS) -> torch.Tensor:
    """SecureML local truncation of a (2, ...) additive sharing: party 0
    shifts its share, party 1 shifts the negation and negates back. For
    |x| << 2^(63 - frac_bits) the reconstruction is (x >> frac_bits) + e
    with |e| <= 1."""
    return torch.stack([shares[0] >> frac_bits, -((-shares[1]) >> frac_bits)])
