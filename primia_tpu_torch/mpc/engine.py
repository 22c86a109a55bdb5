"""The MPC engine: the plain ops of a forward pass, over additive shares.

Port of ``primia_tpu/mpc/engine.py`` on NCHW activations ``(2, B, C, H,
W)`` and OIHW conv weights:

- conv2d / linear: Beaver triples shaped like the op
  (``mpc/beaver.py``), truncation after every fixed-point product;
- relu: one sign extraction and one Beaver product, ``relu(x) = x * (1 -
  msb(x))``; the comparison is the context's protocol: SecureNN
  (``"snn"``, ``mpc/securenn.py``, the default, as in the JAX package) or
  the FSS comparison on kernel K4 (``"fss"``, ``mpc/compare.py``);
- max_pool: the window's shifted views, then a tournament max, each round
  one batched comparison;
- avg_pool: the int64 window sum times ``encode(1 / w^2)``, truncated;
- affine: folded inference batch norm, one Beaver product;
- batch_norm and group_norm: private statistics, the Newton inverse square
  root of ``mpc/functions.py`` (ten steps, where the JAX package takes
  seven: :data:`NORM_RSQRT_ITERATIONS`); group norm's statistics per
  example and group, its divisions by the group's count exact
  (``functions.div_public_int``, a deviation from the JAX package's
  16-bit ``encode(1 / n)``).

Dealer randomness comes from the context's ``torch.Generator``, drawn in
the order the ops run. Not ported yet (ROADMAP, queue 1): the RNN ops.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from primia_tpu_torch.mpc import beaver, compare, fixed, securenn
from primia_tpu_torch.mpc import functions as Fn
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare

# Ring padding of max pooling: decodes to -2^14 at 16 fractional bits,
# far below any activation but inside the 32-bit comparison domain.
_PAD_NEG = -(1 << 30)

# Newton steps of the private norms' rsqrt(var + eps). From its start of
# about 2 at small x, each step grows y by 1.5x until x y^2 nears 1, so
# seven (the JAX package's) reach rsqrt only for x >= ~1e-2; ten reach it
# down to 1e-3. SimpleConv@224's first group norm (one channel a group)
# sees variances near 3e-3 on X-rays, where seven steps leave rsqrt 5% low.
NORM_RSQRT_ITERATIONS = 10


def check_protocol(protocol: str) -> None:
    """``"snn"`` (SecureNN) or ``"fss"`` (the DCF comparison on K4)."""
    if protocol not in ("snn", "fss"):
        raise ValueError(f"unknown MPC protocol {protocol!r}")


class MpcContext:
    """The simulated dealer's random stream for one forward pass, the
    fixed point, and the private-comparison protocol (:func:`check_protocol`).

    ``debug_domains`` (default: ``PRIMIA_MPC_DEBUG_DOMAINS=1``) makes the
    approximations of ``mpc/functions.py`` reveal their operands and raise
    outside their domains: a deliberate breach of privacy, for debugging."""

    def __init__(self, gen: torch.Generator, frac_bits: int = fixed.DEFAULT_FRAC_BITS,
                 protocol: str = "snn", debug_domains: Optional[bool] = None):
        check_protocol(protocol)
        self.gen = gen
        self.frac_bits = frac_bits
        self.protocol = protocol
        if debug_domains is None:
            debug_domains = os.environ.get("PRIMIA_MPC_DEBUG_DOMAINS", "0") == "1"
        self.debug_domains = debug_domains

    def sign_shares(self, x: AShare) -> AShare:
        """Shares of 1{x < 0}, by the context's protocol."""
        if self.protocol == "fss":
            return compare.sign_shares(self.gen, x)
        return securenn.sign_shares(self.gen, x)


def _channel_shape(x: AShare, n_channels: int):
    """Shape that puts a per-channel vector on x's channel axis (axis 1
    of an NCHW or (B, N) value), with the party axis in front."""
    return (2, 1, n_channels) + (1,) * (x.ndim - 2)


class MpcEngine:
    def __init__(self, ctx: MpcContext):
        self.ctx = ctx

    def _truncate(self, z: AShare) -> AShare:
        return AShare(fixed.truncate_shares(z.data, self.ctx.frac_bits))

    def _mul(self, x: AShare, y: AShare) -> AShare:
        return self._truncate(beaver.mul(self.ctx.gen, x, y))

    def _max_pair(self, a: AShare, b: AShare) -> AShare:
        """max(a, b) = a + (b - a) * (1 - msb(b - a)): one comparison and
        one product (not truncated: the bit is an integer)."""
        d = S.sub(b, a)
        pos = S.add_public(S.neg(self.ctx.sign_shares(d)), 1)
        return S.add(a, beaver.mul(self.ctx.gen, d, pos))

    # ---------------------------------------------------------------- ops

    def conv2d(self, x: AShare, w: AShare, stride: int = 1, padding: int = 0) -> AShare:
        return self._truncate(beaver.conv2d(self.ctx.gen, x, w, stride, padding))

    def bias_add(self, x: AShare, b: AShare) -> AShare:
        return AShare(x.data + b.data.reshape(_channel_shape(x, b.shape[0])))

    def affine(self, x: AShare, scale: AShare, offset: AShare) -> AShare:
        """Channelwise x * scale + offset (folded batch norm)."""
        return self.bias_add(self._mul(x, self._per_channel(scale, x)), offset)

    def _per_channel(self, v: AShare, x: AShare) -> AShare:
        """A (C,) sharing broadcast over x's channel axis."""
        return AShare(v.data.reshape(_channel_shape(x, v.shape[0])).expand(x.data.shape))

    def batch_norm(self, x: AShare, mean: AShare, var: AShare, weight: AShare, bias: AShare,
                   eps: float = 1e-5) -> AShare:
        """Inference batch norm with *private* statistics: rsqrt(var + eps)
        by the Newton iteration of ``functions.inverse_sqrt`` on the (C,)
        vectors, then ``(x - mean) * weight * rsqrt + bias``. The
        alternative to the offline fold (:meth:`affine`) when the
        statistics are secret."""
        inv_std = Fn.inverse_sqrt(self.ctx, S.add_public(var, int(fixed.encode(
            eps, self.ctx.frac_bits))), iterations=NORM_RSQRT_ITERATIONS)
        scale = self._mul(weight, inv_std)
        y = self._mul(S.sub(x, self._per_channel(mean, x)), self._per_channel(scale, x))
        return self.bias_add(y, bias)

    def group_norm(self, x: AShare, gamma: AShare, beta: AShare, groups: int = 32,
                   eps: float = 1e-5) -> AShare:
        """*Private* GroupNorm: statistics per example over each of
        ``min(groups, C)`` groups of neighbouring channels, in share space,
        then the channelwise affine with the shared gamma and beta. The
        group sums are local; the mean and the variance divide by the
        public count n = (C / G) H W exactly (``functions.div_public_int``);
        one Beaver square; rsqrt(var + eps) by :data:`NORM_RSQRT_ITERATIONS`
        Newton steps (``functions.inverse_sqrt``: var + eps in ~[1e-3, 200];
        the JAX package takes 7, for ~[1e-2, 200]); one
        product with x - mean. NCHW groups are ``(B, G, C/G * H * W)``: group
        g holds channels g C/G ... (g + 1) C/G - 1, as the JAX package's
        NHWC ``(B, HW, G, C/G)``."""
        _, B, C, H, W = x.data.shape
        G = min(groups, C)
        if C % G:
            raise ValueError(f"group_norm: channels {C} not divisible by groups {G}")
        n = (C // G) * H * W
        xg = x.data.reshape(2, B, G, n)
        mean = Fn.div_public_int(self.ctx, AShare(xg.sum(-1, keepdim=True)), n)
        xc = AShare(xg - mean.data)
        sq = self._mul(xc, xc)
        var = Fn.div_public_int(self.ctx, AShare(sq.data.sum(-1, keepdim=True)), n)
        inv = Fn.inverse_sqrt(self.ctx, S.add_public(var, int(fixed.encode(
            eps, self.ctx.frac_bits))), iterations=NORM_RSQRT_ITERATIONS)
        xhat = self._mul(xc, AShare(inv.data.expand(xg.shape)))
        return self.affine(AShare(xhat.data.reshape(x.data.shape)), gamma, beta)

    def relu(self, x: AShare) -> AShare:
        pos = S.add_public(S.neg(self.ctx.sign_shares(x)), 1)
        return beaver.mul(self.ctx.gen, x, pos)  # a bit product: no truncation

    def max_pool(self, x: AShare, window: int, stride: int, padding: int = 0) -> AShare:
        d = x.data  # (2, B, C, H, W)
        if padding:
            # the public pad enters party 0's share only: padding both
            # would reconstruct to 2 * _PAD_NEG = -2^31, outside the domain
            pad = (padding,) * 4
            d = torch.stack([F.pad(d[0], pad, value=_PAD_NEG), F.pad(d[1], pad, value=0)])
        H, W = d.shape[-2:]
        Ho = (H - window) // stride + 1
        Wo = (W - window) // stride + 1
        views = [AShare(d[..., di:di + (Ho - 1) * stride + 1:stride,
                          dj:dj + (Wo - 1) * stride + 1:stride])
                 for di in range(window) for dj in range(window)]
        # tournament: pair the first half with the second, one batched
        # comparison a round; an odd view waits for the next round
        while len(views) > 1:
            half = len(views) // 2
            merged = self._max_pair(S.stack(views[:half]), S.stack(views[half:2 * half]))
            views = [AShare(m) for m in merged.data.unbind(1)] + views[2 * half:]
        return views[0]

    def avg_pool(self, x: AShare, window: int, stride: int, padding: int = 0) -> AShare:
        d = x.data
        if padding:
            d = F.pad(d, (padding,) * 4)
        summed = d.unfold(-2, window, stride).unfold(-2, window, stride).sum((-2, -1))
        # public division: the product with encode(1 / w^2), truncated
        inv = int(fixed.encode(1.0 / (window * window), self.ctx.frac_bits))
        return self._truncate(AShare(summed * inv))

    def linear(self, x: AShare, w: AShare, b: Optional[AShare] = None) -> AShare:
        """x (B, in) against w in PyTorch's (out, in) layout."""
        z = self._truncate(beaver.matmul(self.ctx.gen, x, AShare(w.data.transpose(1, 2))))
        return z if b is None else self.bias_add(z, b)

    def add(self, x: AShare, y: AShare) -> AShare:
        return S.add(x, y)

    def flatten(self, x: AShare) -> AShare:
        return S.reshape(x, (x.shape[0], -1))


# ----------------------------------------------------------- sharing utils

def encode_and_share(gen: torch.Generator, tensors: Dict[str, torch.Tensor],
                     frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> Dict[str, AShare]:
    """Float tensors -> their fixed-point sharings, drawn in the dict's
    order."""
    return {k: S.share(gen, fixed.encode(v, frac_bits)) for k, v in tensors.items()}


def reveal_and_decode(x: AShare, frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> torch.Tensor:
    """Open and decode, to float64."""
    return fixed.decode(S.reconstruct(x), frac_bits)
