"""Threefry-2x32 PRG of the FSS key trees, in plain PyTorch.

Port of ``primia_tpu/mpc/prg.py``, word for word: the 20-round
Threefry-2x32 block, ``expand`` (the G(s) of the DPF/DCF constructions:
a (..., 4) seed -> two child seeds, their control bits and payload words)
and ``words_to_ring``.

PyTorch has no uint32 add or shift on the CPU, so a 32-bit word lives in
an int64 tensor, in [0, 2^32), between calls. Inside the cipher the
words are int32 bit patterns: two's-complement adds wrap mod 2^32, a
left shift drops the high bits, and a right shift is masked to the bits
a logical shift keeps. The card's kernel (``csrc/dcf.cu``) runs the same
cipher on native ``uint32_t``; this module is its plain version's PRG.
``expand_child`` computes only one child, as an evaluation walk needs.
"""

from __future__ import annotations

import torch

_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
MASK32 = 0xFFFFFFFF
N_BLOCKS = 6


def threefry2x32(key0, key1, x0, x1):
    """One Threefry-2x32-20 block per element: encrypts the counter
    (x0, x1) under (key0, key1). int64 tensors of 32-bit words that
    broadcast together; returns two such tensors of the broadcast shape."""
    ks = tuple(k.to(torch.int32) for k in (key0, key1, key0 ^ key1 ^ _PARITY))
    x0, x1 = (t.to(torch.int32) for t in torch.broadcast_tensors(x0 + key0, x1 + key1))
    for group in range(5):
        for r in range(4):
            rot = _ROTATIONS[(group % 2) * 4 + r]
            x0.add_(x1)
            low = (x1 >> (32 - rot)).bitwise_and_((1 << rot) - 1)
            x1.bitwise_left_shift_(rot).bitwise_or_(low)
            x1.bitwise_xor_(x0)
        x0.add_(ks[(group + 1) % 3])
        x1.add_(ks[(group + 2) % 3]).add_(group + 1)
    return x0.to(torch.int64) & MASK32, x1.to(torch.int64) & MASK32


def _blocks(seed: torch.Tensor, n_blocks: int):
    """(..., 4) seed -> two (n_blocks, ...) word tensors: block c encrypts
    the counter (seed[2] ^ c, seed[3]) under the key (seed[0], seed[1]).
    All blocks run as one batched cipher call."""
    c = torch.arange(n_blocks, dtype=torch.int64, device=seed.device)
    c = c.reshape(n_blocks, *([1] * (seed.dim() - 1)))
    return threefry2x32(seed[..., 0], seed[..., 1], seed[..., 2] ^ c, seed[..., 3])


def expand(seed: torch.Tensor):
    """G(s): seed (..., 4) -> (sL, tL, vL, sR, tR, vR).

    sL/sR: (..., 4) child seeds; tL/tR: (...) control bits, the LSB of
    each child's first word, which is then zeroed in the seed
    (lambda = 127); vL/vR: (..., 2) payload words. Words 0..11 are the
    outputs of blocks 0..5 in order (o0, o1 of each)."""
    o0, o1 = _blocks(seed, N_BLOCKS)
    w = torch.stack([o0, o1], dim=1).flatten(0, 1)  # (12, ...)
    tL = w[0] & 1
    tR = w[4] & 1
    sL = torch.stack([w[0] & ~1 & MASK32, w[1], w[2], w[3]], dim=-1)
    sR = torch.stack([w[4] & ~1 & MASK32, w[5], w[6], w[7]], dim=-1)
    vL = torch.stack([w[8], w[9]], dim=-1)
    vR = torch.stack([w[10], w[11]], dim=-1)
    return sL, tL, vL, sR, tR, vR


def expand_child(seed: torch.Tensor, side: torch.Tensor):
    """One child of G(s): ``(s, t, v)`` of side ``side`` (0 = L, 1 = R, a
    (...) int64 tensor), word for word the ``side`` half of
    :func:`expand`. The block counters are data, so the side moves into
    the counter: blocks 2 side and 2 side + 1 give the seed, block
    4 + side the payload, 3 blocks instead of 6 (what an evaluation walk
    needs, and the kernel's ``child``)."""
    ctr = torch.stack([2 * side, 2 * side + 1, 4 + side]) ^ seed[..., 2]
    o0, o1 = threefry2x32(seed[..., 0], seed[..., 1], ctr, seed[..., 3])
    s = torch.stack([o0[0] & ~1 & MASK32, o1[0], o0[1], o1[1]], dim=-1)
    return s, o0[0] & 1, torch.stack([o0[2], o1[2]], dim=-1)


def words_to_ring(v: torch.Tensor) -> torch.Tensor:
    """(..., 2) payload words -> int64 ring element, ``lo | hi << 32``."""
    return v[..., 0] | (v[..., 1] << 32)
