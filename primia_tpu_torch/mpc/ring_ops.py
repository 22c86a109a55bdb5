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
shift level without leaving int32). A deeper contraction (a weight
gradient contracts over batch x output pixels) runs in chunks under that
depth whose sums are added in int64, which wraps and so stays exact mod
2^64. The 36 products are 8 GEMMs a chunk: for each limb j of B, the
limbs 0..7-j of A stacked on the rows. A convolution is an explicit
im2col (``Tensor.unfold``, any dtype) of the limbs, then the same GEMMs;
:func:`ring_conv_general` adds the zero-dilated input, asymmetric padding
and the dilated kernel that the share-space gradients need. This is a
library product, as the JAX package left it to XLA, and no hand-written
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

N_LIMBS = 8
# 0x8080808080808080 as int64: adding it carries a 128 into every byte,
# and xoring it back leaves each byte b_i + 128 of the signed digits.
_BIAS = -0x7F7F7F7F7F7F7F80
# the deepest chunk whose int32 limb sums cannot overflow: 8 products of
# |b_i b_j| <= 2^14 over K terms stay under 2^31 for K < 2^14
_CHUNK = (1 << 14) - 8


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
    above 16, as ``torch._int_mm`` requires; contracts in chunks of at most
    ``_CHUNK`` whose int32 sums are added in int64."""
    _, M, K = la.shape
    N = lbt.shape[1]
    Mp, Kp, Np = max(M, 17), _round_up(K, 8), _round_up(N, 8)
    if (Mp, Kp) != (M, K):
        la = F.pad(la, (0, Kp - K, 0, Mp - M))
    if (Np, Kp) != (N, K):
        lbt = F.pad(lbt, (0, Kp - K, 0, Np - N))
    # acc[k] = sum_{i+j=k} A_i @ B_j: exact in int32 within a chunk
    # (|acc| < 8 * _CHUNK * 2^14), summed over the chunks in int64
    acc = None
    for k0 in range(0, Kp, _CHUNK):
        a, bt = la[..., k0:k0 + _CHUNK].contiguous(), lbt[..., k0:k0 + _CHUNK].contiguous()
        part = torch.zeros((N_LIMBS, Mp, Np), dtype=torch.int32, device=la.device)
        for j in range(N_LIMBS):
            n_i = N_LIMBS - j
            p = torch._int_mm(a[:n_i].reshape(n_i * Mp, -1), bt[j].t())
            part[j:] += p.view(n_i, Mp, Np)
        acc = part.long() if acc is None else acc.add_(part)
    out = acc[N_LIMBS - 1]
    for k in range(N_LIMBS - 2, -1, -1):  # Horner: sum_k acc[k] << 8k
        out = out.bitwise_left_shift(8).add_(acc[k])
    return out[:M, :N]


def limb_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) @ (K, N) mod 2^64 through int8 limb products, on any device."""
    return _limb_mm(to_limbs(a), to_limbs(b.t()))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride=(1, 1), dilation=(1, 1)):
    """(N, C, H, W) of any dtype, already padded -> ((N * Ho * Wo, C * kh *
    kw), Ho, Wo); columns in OIHW weight order (c, i, j). A dilated window
    is the span it covers, unfolded, then every ``dilation``-th tap."""
    (sh, sw), (dh, dw) = stride, dilation
    p = x.unfold(2, (kh - 1) * dh + 1, sh).unfold(3, (kw - 1) * dw + 1, sw)
    p = p[..., ::dh, ::dw]  # (N, C, Ho, Wo, kh, kw)
    N, C, Ho, Wo = p.shape[:4]
    return p.permute(0, 2, 3, 1, 4, 5).reshape(N * Ho * Wo, C * kh * kw), Ho, Wo


def _dilate_and_pad(x: torch.Tensor, padding, lhs_dilation) -> torch.Tensor:
    """``x`` (N, C, H, W) with ``lhs_dilation - 1`` zeros between
    neighbouring pixels, then padded by ((top, bottom), (left, right)); a
    negative pad crops, as in ``conv_general_dilated``."""
    dh, dw = lhs_dilation
    if (dh, dw) != (1, 1):
        N, C, H, W = x.shape
        z = x.new_zeros((N, C, (H - 1) * dh + 1, (W - 1) * dw + 1))
        z[..., ::dh, ::dw] = x
        x = z
    (pt, pb), (pl, pr) = padding
    return F.pad(x, (pl, pr, pt, pb)) if any((pt, pb, pl, pr)) else x


def limb_conv2d(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """NCHW x OIHW conv mod 2^64 through int8 limb products, on any device:
    the limbs of x go through im2col (one byte a digit), then the GEMMs."""
    return limb_conv_general(x, w, stride=(stride, stride),
                             padding=((padding, padding), (padding, padding)))


def limb_conv_general(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                      padding=((0, 0), (0, 0)), lhs_dilation=(1, 1),
                      rhs_dilation=(1, 1)) -> torch.Tensor:
    """:func:`ring_conv_general` through int8 limb products, on any device."""
    B = x.shape[0]
    O, C, kh, kw = w.shape
    lx = _dilate_and_pad(to_limbs(x).flatten(0, 1), padding, lhs_dilation)
    cols, Ho, Wo = _im2col(lx, kh, kw, stride, rhs_dilation)
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


def ring_conv_general(x: torch.Tensor, w: torch.Tensor, *, stride=(1, 1),
                      padding=((0, 0), (0, 0)), lhs_dilation=(1, 1),
                      rhs_dilation=(1, 1)) -> torch.Tensor:
    """Exact mod-2^64 ``conv_general_dilated`` of NCHW int64 ``x`` and OIHW
    ``w``: the form the share-space conv gradients need (the input
    gradient is a conv of the stride-dilated output gradient, the weight
    gradient a batch-contracting conv with a dilated kernel). ``padding``
    is ((top, bottom), (left, right)); a dilation is (rows, columns)."""
    if x.device.type == "cpu":
        xd = _dilate_and_pad(x, padding, lhs_dilation)
        return F.conv2d(xd, w, stride=tuple(stride), dilation=tuple(rhs_dilation))
    return limb_conv_general(x, w, stride=stride, padding=padding,
                             lhs_dilation=lhs_dilation, rhs_dilation=rhs_dilation)
