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

The JAX package's tiled ``lax.map`` form is its XLA fallback and is not
ported: K4 takes any N in one launch and keeps no key material.
"""

from __future__ import annotations

import torch

from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare
from primia_tpu_torch.ops.cuda_dcf import dcf_sign

_LOW31 = (1 << 31) - 1
N_BITS = 31


def sign_shares(gen: torch.Generator, x: AShare) -> AShare:
    """Dealer and online phase in one call: shares of 1{x < 0}, any shape.
    Draws from ``gen``: r, the root seeds, c's sharing, r's sharing."""
    flat = S.reshape(x, (-1,))
    n = flat.shape[0]
    r = S.rand_ring(gen, (n,))
    r32 = r & 0xFFFFFFFF
    c = r32 >> 31
    seeds = torch.randint(-(1 << 31), 1 << 31, (2, n, 4), dtype=torch.int32,
                          generator=gen, device=gen.device)
    c_sh = S.share(gen, c)
    x_hat = S.reconstruct(S.add(flat, S.share(gen, r))) & 0xFFFFFFFF  # the opening
    a = x_hat >> 31
    w = dcf_sign(seeds, (r32 & _LOW31).int(), c.int(), (x_hat & _LOW31).int(), N_BITS)
    e = w + c_sh.data
    lin = 1 - 2 * a
    return S.reshape(AShare(torch.stack([a + lin * e[0], lin * e[1]])), x.shape)
