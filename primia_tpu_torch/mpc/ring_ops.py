"""Exact mod-2^64 matrix products and convolutions (NCHW / OIHW).

Port of ``primia_tpu/mpc/ring_ops.py``. On the CPU, PyTorch's int64
``@`` and ``F.conv2d`` wrap, which is ring arithmetic, and they are used
as they are (the JAX package does the same on its CPU). CUDA has neither
op for int64, so there the product is built from signed byte limbs, as
the JAX package builds it for the TPU:

    v = sum_i b_i * 2^(8 i),  b_i in [-128, 127]
    A @ B mod 2^64 = sum_{i+j <= 7} (A_i @ B_j) << 8(i+j)

Each limb product is ``torch._int_mm`` (int8 x int8 -> int32, exact:
|b_i b_j| <= 2^14, so a depth K < 2^14 sums the eight products of one
shift level without leaving int32). The 36 products are 8 GEMMs: for
each limb j of B, the limbs 0..7-j of A stacked on the rows. A
convolution is an explicit im2col (``Tensor.unfold``, any dtype) of the
limbs, then the same GEMMs. This is a library product, as the JAX package
left it to XLA, and no hand-written kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

N_LIMBS = 8
# 0x8080808080808080 as int64: adding it carries a 128 into every byte,
# and xoring it back leaves each byte b_i + 128 of the signed digits.
_BIAS = -0x7F7F7F7F7F7F7F80
_MAX_DEPTH = 1 << 14


def to_limbs(v: torch.Tensor) -> torch.Tensor:
    """int64 (...) -> int8 (8, ...): the signed base-256 digits, least
    significant first (the same digits as the JAX package's carry loop;
    the representation with every digit in [-128, 127] is unique). Each
    byte of ``(v + 0x80..80) ^ 0x80..80`` read as int8 is one digit; bytes
    are read in little-endian order, which both the CPU and the card use."""
    w = (v + _BIAS) ^ _BIAS
    return w.reshape(-1, 1).view(torch.int8).t().reshape(N_LIMBS, *v.shape)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _limb_mm(la: torch.Tensor, lbt: torch.Tensor) -> torch.Tensor:
    """(8, M, K) int8 limbs of A and (8, N, K) int8 limbs of B^T ->
    (M, N) int64 = A @ B mod 2^64. Pads K and N to multiples of 8 and M
    above 16, as ``torch._int_mm`` requires."""
    _, M, K = la.shape
    N = lbt.shape[1]
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(N, 8)
    if Kp >= _MAX_DEPTH:
        raise ValueError(f"contraction depth {K} too large for the int32 limb sums")
    if (Mp, Kp) != (M, K):
        la = F.pad(la, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        lbt = F.pad(lbt, (0, Kp - K, 0, Np - N))
    la, lbt = la.contiguous(), lbt.contiguous()
    # acc[k] = sum_{i+j=k} A_i @ B_j, exact in int32 (|acc| < 8 * Kp * 2^14)
    acc = torch.zeros((N_LIMBS, Mp, Np), dtype=torch.int32, device=la.device)
    for j in range(N_LIMBS):
        n_i = N_LIMBS - j
        p = torch._int_mm(la[:n_i].reshape(n_i * Mp, Kp), lbt[j].t())
        acc[j:] += p.view(n_i, Mp, Np)
    out = acc[N_LIMBS - 1].long()
    for k in range(N_LIMBS - 2, -1, -1):  # Horner: sum_k acc[k] << 8k
        out = out.bitwise_left_shift_(8).add_(acc[k])
    return out[:M, :N]


def limb_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) mod 2^64 through int8 limb products, on any device."""
    return _limb_mm(to_limbs(a), to_limbs(b.t()))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int):
    """(N, C, H, W) of any dtype -> ((N * Ho * Wo, C * kh * kw), Ho, Wo),
    zero-padded; columns in OIHW weight order (c, i, j)."""
    if padding:
        x = F.pad(x, (padding,) * 4)
    p = x.unfold(2, kh, stride).unfold(3, kw, stride)  # (N, C, Ho, Wo, kh, kw)
    N, C, Ho, Wo = p.shape[:4]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(N * Ho * Wo, C * kh * kw), Ho, Wo


def limb_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NCHW x OIHW conv mod 2^64 through int8 limb products, on any device:
    the limbs of x go through im2col (one byte a digit), then the GEMMs."""
    B = x.shape[0]
    O, C, kh, kw = w.shape
    cols, Ho, Wo = _im2col(to_limbs(x).flatten(0, 1), kh, kw, stride, padding)
    out = _limb_mm(cols.view(N_LIMBS, B * Ho * Wo, C * kh * kw),
                   to_limbs(w).reshape(N_LIMBS, O, C * kh * kw))
    return out.view(B, Ho, Wo, O).permute(0, 3, 1, 2).contiguous()


def ring_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (a @ b) mod 2^64 for int64 (M, K) and (K, N) operands."""
    if a.device.type == "cpu":
        return a @ b
    return limb_matmul(a, b)


def ring_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """Exact NCHW/OIHW conv mod 2^64 for int64 operands."""
    if x.device.type == "cpu":
        return F.conv2d(x, w, stride=stride, padding=padding)
    return limb_conv2d(x, w, stride, padding)
