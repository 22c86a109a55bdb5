"""Private comparison via DCF: shares of the sign bit, 1{x < 0}.

Port of ``primia_tpu/mpc/compare.py:_sign_shares_fused``, the protocol
the TPU runs by default, with the same draws in the same order. One
31-bit DCF key per element at ``alpha = low31(r)`` and the borrow
identity over the 32-bit comparison domain:

    x_hat = (x + r) mod 2^32 opened,   A = msb(x_hat) public
    msb(x) = A XOR msb(r) XOR 1{low31(x_hat) < low31(r)}

The dealer folds ``c = msb(r)`` into the DCF payload ``1 - 2c`` and
shares ``c``; with ``w`` the DCF's shares, ``e = c + w`` shares
``msb(r) XOR 1{...}`` and ``msb(x) = A + (1 - 2A) e``. The key walk and
both parties' evaluations are the one kernel K4
(``ops/cuda_dcf.py:dcf_sign``). Correct whenever |x| < 2^31.

The same protocol split into its dealer phase (:func:`gen_compare`, the
keys materialised) and its online phase (:func:`msb`, the DCF walk in
plain torch, as the JAX package's XLA scan) draws in the same order, so
``msb(x, gen_compare(g, n))`` equals ``sign_shares(g, x)`` bit for bit.
On a CUDA tensor :func:`sign_shares` launches K4 or raises; the split form
is not its fallback. The JAX package's tiled ``lax.map`` form is its XLA
fallback and is not ported: K4 takes any N in one launch and keeps no key
material.

Party-split sharings (``shares.Parties``): K4 fuses the dealer's key
generation with both parties' evaluation, so it runs on the dealer's
device, where the masked value is opened; each party then receives its
half of K4's output (party 1's on party 1's device) and of ``c``'s
sharing, and combines on its own device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.dcf import DcfKeys, dcf_eval, dcf_gen_from_seeds
from primia_tpu_torch.mpc.prg import MASK32
from primia_tpu_torch.mpc.shares import AShare
from primia_tpu_torch.ops.cuda_dcf import dcf_sign

_LOW31 = (1 << 31) - 1
N_BITS = 31


class CompareKeys(NamedTuple):
    r: AShare      # (2, N) shares of the mask
    keys: DcfKeys  # one 31-bit DCF key an element at alpha = low31(r)
    c: AShare      # (2, N) shares of msb(r mod 2^32)


def _draw(gen: torch.Generator, n: int):
    """The dealer's draws, in :func:`sign_shares`'s order: r, the int32
    root seeds, c's sharing, r's sharing; returns (r32, seeds, c, c
    sharing, r sharing)."""
    r = S.rand_ring(gen, (n,))
    r32 = r & MASK32
    c = r32 >> 31
    seeds = torch.randint(-(1 << 31), 1 << 31, (2, n, 4), dtype=torch.int32,
                          generator=gen, device=gen.device)
    c_sh = S.share(gen, c)
    return r32, seeds, c, c_sh, S.share(gen, r)


def gen_compare(gen: torch.Generator, n: int) -> CompareKeys:
    """The dealer phase for a batch of n sign extractions: one DCF key an
    element for ``beta = 1 - 2 msb(r)`` at ``alpha = low31(r)``."""
    r32, seeds, c, c_sh, r_sh = _draw(gen, n)
    keys = dcf_gen_from_seeds(seeds.long() & MASK32, r32 & _LOW31, 1 - 2 * c, N_BITS)
    return CompareKeys(r_sh, keys, c_sh)


def _combine(a: torch.Tensor, e) -> AShare:
    """msb = A + (1 - 2A) e, the public A applied by party 0 alone."""
    lin = 1 - 2 * a
    on = S.public_on
    return AShare(S.join(e, on(a, e[0]) + on(lin, e[0]) * e[0], on(lin, e[1]) * e[1]))


def msb(x: AShare, ck: CompareKeys) -> AShare:
    """The online phase: shares of 1{x < 0} for a flat (N,) sharing. Both
    parties evaluate as one mixed-party walk of (2, N) lanes, the same key
    and the same opened point."""
    n = x.shape[-1]
    x_hat = S.reconstruct(S.add(x, ck.r)) & MASK32  # the opening
    party = torch.tensor([[0], [1]], dtype=torch.int64, device=x_hat.device)
    w = dcf_eval(party, ck.keys, (x_hat & _LOW31).expand(2, n), N_BITS)
    return _combine(x_hat >> 31, w + ck.c.data)


def sign_shares(gen: torch.Generator, x: AShare) -> AShare:
    """Dealer and online phase in one call: shares of 1{x < 0}, any shape.
    Draws from ``gen`` as :func:`gen_compare` does."""
    flat = S.reshape(x, (-1,))
    r32, seeds, c, c_sh, r_sh = _draw(gen, flat.shape[0])
    r_sh = AShare(S.deliver(r_sh.data, flat.data))
    x_hat = S.reconstruct(S.add(flat, r_sh)) & MASK32  # the opening
    w = dcf_sign(seeds, (r32 & _LOW31).int(), c.int(), (x_hat & _LOW31).int(), N_BITS)
    e = S.deliver(w, flat.data) + S.deliver(c_sh.data, flat.data)
    return S.reshape(_combine(x_hat >> 31, e), x.shape)
