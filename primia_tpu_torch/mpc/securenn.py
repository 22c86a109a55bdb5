"""SecureNN: the dealer-assisted comparison (``--protocol snn``), share
conversion to Z_{2^64 - 1} and private integer division.

Port of ``primia_tpu/mpc/securenn.py``. The sign of a sharing over Z_2^n
(n = 32 by default, correct whenever |x| < 2^(n-1); n = 64 for
:func:`division`): the dealer draws r, the parties open ``c = x + r mod
2^n`` and

    bit_{n-1}(x) = bit_{n-1}(c) XOR bit_{n-1}(r) XOR 1{c mod 2^(n-1) < r mod 2^(n-1)}

where the borrow comes from SecureNN's bit circuit over Z_67 on public bits
of c and shared bits of r, masked by common nonzero ``s`` and opened by
the dealer (:func:`_borrow`). One Beaver product takes the XOR of the two
shared bits. The JAX package runs no Pallas kernel here, and neither does
the port: these are plain tensor ops.

PyTorch has no unsigned arithmetic on the card, so:

- a Z_2^32 value is an int64 in [0, 2^32), masked after every add;
- a Z_2^64 or Z_M value (M = 2^64 - 1) is an int64 bit pattern, compared
  as unsigned after an XOR with 2^63 (:func:`_ult`);
- ``>>`` on int64 is arithmetic, so a shifted bit is masked with ``& 1``;
- the bit circuit runs in int16: its prefix sums stay under 64 * 67, and
  ``t`` is reduced mod 67 before the product with ``s`` (< 67 * 67),
  which leaves every masked residue as the JAX package's int32 ``(t * s) %
  67`` (``%`` on tensors is floor-mod, as ``jnp``'s).

Randomness is drawn from a ``torch.Generator`` on the shares' device, in
the order the JAX package splits its keys. :func:`msb` and :func:`_borrow`
take the dealer's material explicitly, so tests hand both packages the
same keys.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from primia_tpu_torch.mpc import beaver
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare

N_BITS = 32  # the default comparison domain
_P = 67  # the bit circuit's field
MASK32 = 0xFFFFFFFF
M_RING = -1  # 2^64 - 1 as an int64 bit pattern
_SIGN = -(1 << 63)  # 2^63: XORed in, it turns an unsigned order into int64's


class SnnKeys(NamedTuple):
    r_sh: torch.Tensor      # (2, N) int64: shares of the opening mask r over Z_2^n
    rbits_sh: torch.Tensor  # (2, N, n-1) int16: Z_67 shares of r's low bits, MSB first
    b_r: AShare             # (2, N) int64: arithmetic shares of bit_{n-1}(r)
    s: torch.Tensor         # (N, n-1) int16: common nonzero masks in Z_67*
    u: torch.Tensor         # (N,) int64: the dealer's re-share randomness


def _ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b for int64 bit patterns read as unsigned 64-bit values."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _wrap(v: torch.Tensor, n_bits: int) -> torch.Tensor:
    """v mod 2^n_bits (an int64 bit pattern is already mod 2^64)."""
    return v & MASK32 if n_bits == 32 else v


def _rand_bits(gen: torch.Generator, n: int, n_bits: int) -> torch.Tensor:
    """Uniform (n,) draws over Z_2^n_bits."""
    if n_bits == 64:
        return S.rand_ring(gen, (n,))
    return torch.randint(0, 1 << 32, (n,), dtype=torch.int64, generator=gen, device=gen.device)


def _randint(gen: torch.Generator, low: int, high: int, shape) -> torch.Tensor:
    return torch.randint(low, high, shape, dtype=torch.int16, generator=gen, device=gen.device)


def _bit_major(t: torch.Tensor) -> torch.Tensor:
    """A (..., N, nb) tensor as int16 (..., nb, N) in memory: the bit
    circuit's prefix sum then runs over an outer dimension, where PyTorch's
    scan is coalesced (its innermost-dimension scan over 31 elements took
    62% of the device time of a SecureNN ResNet-18 forward at 224 px, batch
    4, on an H100). No copy when ``t`` is already a transposed view of such
    a tensor, as the dealer makes them."""
    return t.to(torch.int16).transpose(-1, -2).contiguous()


def _decompose(v: torch.Tensor, nb: int) -> torch.Tensor:
    """Public bit decomposition, MSB first: the nb low bits of (N,) int64
    -> (N, nb) int16 (a view of a bit-major (nb, N) tensor)."""
    shifts = torch.arange(nb - 1, -1, -1, dtype=torch.int64, device=v.device)
    return ((v[None, :] >> shifts[:, None]) & 1).to(torch.int16).t()


def _share_bits(gen: torch.Generator, bits: torch.Tensor) -> torch.Tensor:
    """(N, nb) public bits -> (2, N, nb) int16 shares over Z_67 (bit-major
    in memory)."""
    b0 = _randint(gen, 0, _P, bits.t().shape)
    return torch.stack([b0, (bits.t() - b0) % _P]).transpose(1, 2)


def _borrow(cbits: torch.Tensor, rbits_sh: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """SecureNN's bit circuit and the dealer's step: 1{c < r} over the given
    width from public bits ``cbits`` (N, nb) and Z_67 shares ``rbits_sh``
    (2, N, nb) of r's bits, both MSB first, masked by ``s`` (N, nb).
    Returns the dealer's plaintext borrow bit (N,) int64 (the caller
    re-shares it).

    With e_i = c_i XOR r_i = c_i + r_i - 2 c_i r_i and the exclusive prefix
    sum of e, t_i = c_i - r_i + 1 + prefix_i is 0 mod 67 at the first
    differing bit iff r > c there, and nonzero everywhere else; each party
    sends ``t * s``, the dealer opens their sum."""
    c, r, s = _bit_major(cbits), _bit_major(rbits_sh), _bit_major(s)  # (nb, N), (2, nb, N)
    e = r - 2 * c * r
    e[0] += c
    prefix = torch.cumsum(e, dim=1, dtype=torch.int16) - e
    t = prefix - r
    t[0] += c + 1
    d = (t % _P) * s % _P  # each party's masked residues
    dv = (d[0] + d[1]) % _P
    return (dv == 0).any(dim=0).to(torch.int64)


def gen_sign(gen: torch.Generator, n: int, n_bits: int = N_BITS) -> SnnKeys:
    """The dealer's material for n sign extractions over Z_2^n_bits."""
    nb = n_bits - 1
    r = _rand_bits(gen, n, n_bits)
    r0 = _rand_bits(gen, n, n_bits)
    r_sh = torch.stack([r0, _wrap(r - r0, n_bits)])
    rbits_sh = _share_bits(gen, _decompose(r, nb))
    b_r = S.share(gen, (r >> nb) & 1)
    s = _randint(gen, 1, _P, (nb, n)).t()
    u = S.rand_ring(gen, (n,))
    return SnnKeys(r_sh, rbits_sh, b_r, s, u)


def msb(gen: torch.Generator, x: AShare, keys: SnnKeys) -> AShare:
    """Shares of 1{x < 0} for a flat (N,) sharing, |x| < 2^(n_bits - 1),
    n_bits from the keys; ``gen`` draws the Beaver triple."""
    nb = keys.rbits_sh.shape[-1]
    n_bits = nb + 1
    # the opening of c = x + r mod 2^n: each party adds its mask share
    masked = x.data + keys.r_sh
    c = _wrap(masked[0] + masked[1], n_bits)
    b_c = (c >> nb) & 1  # public bit_{n-1}(c)
    beta = _borrow(_decompose(c, nb), keys.rbits_sh, keys.s)
    borrow = AShare(torch.stack([keys.u, beta - keys.u]))
    # msb = b_c XOR b_r XOR borrow; one Beaver product for b_r XOR borrow
    br_x_bw = beaver.mul(gen, keys.b_r, borrow)
    B = S.add(S.add(keys.b_r, borrow), S.mul_public(br_x_bw, -2))
    return S.add_public(S.mul_public(B, 1 - 2 * b_c), b_c)


def sign_shares(gen: torch.Generator, x: AShare, n_bits: int = N_BITS) -> AShare:
    """The dealer's and the online phase in one call: shares of 1{x < 0},
    any shape. A drop-in for ``compare.sign_shares`` (the FSS path)."""
    flat = S.reshape(x, (-1,))
    keys = gen_sign(gen, flat.shape[0], n_bits)
    return S.reshape(msb(gen, flat, keys), x.shape)


# ------------------------------------------------------------ select_share

def select_share(gen: torch.Generator, alpha: AShare, x: AShare, y: AShare) -> AShare:
    """``(1 - alpha) x + alpha y`` for a shared bit ``alpha``: one Beaver
    product, then re-randomised shares."""
    z = S.add(x, beaver.mul(gen, alpha, S.sub(y, x)))
    fresh = S.rand_ring(gen, z.shape)
    return AShare(torch.stack([z.data[0] + fresh, z.data[1] - fresh]))


# ----------------------------------------------------------- share_convert

class ConvertKeys(NamedTuple):
    r_sh: torch.Tensor      # (2, N) int64: shares of r over Z_2^64
    rbits_sh: torch.Tensor  # (2, N, 64) int16: Z_67 shares of all r's bits
    neg_r_m: torch.Tensor   # (2, N) int64: shares over Z_M of (-r mod M)
    s: torch.Tensor         # (N, 64) int16: common masks
    u_m: torch.Tensor       # (N,) int64: the dealer's re-share randomness in Z_M


def add_mod_m(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Addition in Z_M, M = 2^64 - 1, of operands below M (bit patterns).
    A wrap of the 64-bit sum loses 2^64 = 1 (mod M), so it adds 1 back;
    then the one value at or above M, M itself, becomes 0."""
    sw = a + b
    sv = sw + _ult(sw, a).to(torch.int64)
    return torch.where(sv == M_RING, torch.zeros_like(sv), sv)


def neg_mod_m(a: torch.Tensor) -> torch.Tensor:
    """-a in Z_M: M - a, which is ~a as a bit pattern; 0 stays 0."""
    return torch.where(a == 0, a, ~a)


def reconstruct_mod_m(shares: torch.Tensor) -> torch.Tensor:
    """Open a (2, ...) Z_M sharing."""
    return add_mod_m(shares[0], shares[1])


def _below_m(v: torch.Tensor) -> torch.Tensor:
    """min(v, M - 1) as unsigned values: only M itself moves."""
    return torch.where(v == M_RING, torch.full_like(v, M_RING - 1), v)


def gen_convert(gen: torch.Generator, n: int) -> ConvertKeys:
    r = S.rand_ring(gen, (n,))
    r0 = S.rand_ring(gen, (n,))
    r_sh = torch.stack([r0, r - r0])
    rbits_sh = _share_bits(gen, _decompose(r, 64))
    # shares over Z_M of (-r mod M); r mod M maps 2^64 - 1 to 0
    r_m = torch.where(r == M_RING, torch.zeros_like(r), r)
    nr0 = _below_m(S.rand_ring(gen, (n,)))
    neg_r_m = torch.stack([nr0, add_mod_m(neg_mod_m(r_m), neg_mod_m(nr0))])
    s = _randint(gen, 1, _P, (64, n)).t()
    u_m = _below_m(S.rand_ring(gen, (n,)))
    return ConvertKeys(r_sh, rbits_sh, neg_r_m, s, u_m)


def share_convert(gen: torch.Generator, x: AShare) -> torch.Tensor:
    """A Z_{2^64} sharing -> a Z_{2^64 - 1} sharing of the same value, for a
    value other than 2^64 - 1. Open ``c = a + r`` over Z_2^64; over the
    integers ``a = c - r + 2^64 w`` with ``w = 1{c < r}``, and 2^64 = 1
    (mod M), so ``a = c - r + w (mod M)``. ``w`` comes from the 64-bit bit
    circuit, the dealer shares ``-r`` over Z_M. Returns (2, ...) int64 bit
    patterns of shares in Z_M (open with :func:`reconstruct_mod_m`)."""
    flat = S.reshape(x, (-1,))
    keys = gen_convert(gen, flat.shape[0])
    masked = flat.data + keys.r_sh
    c = masked[0] + masked[1]  # public, uniform in Z_2^64
    w = _borrow(_decompose(c, 64), keys.rbits_sh, keys.s)
    # the dealer re-shares w over Z_M
    w_sh = torch.stack([keys.u_m, add_mod_m(w, neg_mod_m(keys.u_m))])
    c_m = torch.where(c == M_RING, torch.zeros_like(c), c)
    y0 = add_mod_m(add_mod_m(c_m, keys.neg_r_m[0]), w_sh[0])
    y1 = add_mod_m(keys.neg_r_m[1], w_sh[1])
    return torch.stack([y0, y1]).reshape(2, *x.shape)


# --------------------------------------------------------------- division

def division(gen: torch.Generator, x: AShare, y: AShare, bit_len_max: int = 32) -> AShare:
    """Private integer division: shares of ``floor(x / y)`` for non-negative
    ``x`` and positive ``y`` (a scalar sharing or one of x's shape).

    SecureNN's long division: for each bit i from high to low, test ``x - u
    - 2^i y >= 0`` with one 64-bit sign extraction (the magnitudes exceed
    the 32-bit domain), subtract conditionally and add ``2^i`` to the
    quotient. Requires ``2^bit_len_max * y < 2^62``."""
    if y.shape != x.shape and math.prod(y.shape) != 1:
        raise ValueError(
            f"division: divisor shape {tuple(y.shape)} must be scalar (size 1) or exactly "
            f"match the dividend shape {tuple(x.shape)}")
    xf = S.reshape(x, (-1,))
    if y.shape == x.shape:
        yf = S.reshape(y, (-1,))
    else:
        yf = AShare(y.data.reshape(2, 1).expand(xf.data.shape))
    u = S.zeros_like(xf)
    q = S.zeros_like(xf)
    for i in range(bit_len_max - 1, -1, -1):
        two_i_y = S.mul_public(yf, 1 << i)
        z = S.sub(S.sub(xf, u), two_i_y)
        beta = S.add_public(S.neg(sign_shares(gen, z, n_bits=64)), 1)  # 1{z >= 0}
        u = S.add(u, beaver.mul(gen, beta, two_i_y))
        q = S.add(q, S.mul_public(beta, 1 << i))
    return S.reshape(q, x.shape)
