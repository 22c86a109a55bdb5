"""The share-space function library: approximations over fixed-point
sharings.

Port of ``primia_tpu/mpc/functions.py``, formula for formula: ``exp`` by
its limit, ``log`` by Householder iterations, ``reciprocal`` (``nr``,
``newton``, ``log``) and ``div`` (``reciprocal``, ``securenn``), Newton
``inverse_sqrt`` and ``sqrt``, Newton-Schulz ``inverse``, Chebyshev
``tanh`` and ``sigmoid`` (and the ``exp`` and ``maclaurin`` sigmoids),
the fixed-round pairwise ``argmax``/``argmin``/``max``/``min`` (and
``maxpool``/``maxpool_deriv`` on them), ``mean`` and ``var``. Every
comparison batch is one call of the context's sign extraction (SecureNN or
the FSS kernel K4, by ``ctx.protocol``); public coefficients are encoded
once and truncated once; sums of products truncate once.

Each function takes the engine's ``MpcContext`` (its dealer generator
``ctx.gen``, ``ctx.frac_bits``, ``ctx.debug_domains``) and ``AShare``
operands encoded at ``2 ** ctx.frac_bits``. Domains are the formulas'
own; with ``PRIMIA_MPC_DEBUG_DOMAINS=1`` an operand outside them raises
(:func:`_domain_check`). The port also checks ``inverse_sqrt``'s
documented domain there, which the JAX package leaves unchecked.

One deviation on purpose: a division by a public count ``n``
(:func:`div_public_int`, used by :func:`mean` and the engine's private
norms) is exact to a few units in the last place for any n. The JAX
package multiplies by ``encode(1 / n)`` at 16 fractional bits, which is
15% high at n = 25,088 (2^16 / n = 2.61 rounds to 3).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from primia_tpu_torch.mpc import beaver, fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare


# --------------------------------------------------------------- helpers

def _domain_check(ctx, x: AShare, lo: float, hi: float, fn_name: str, *,
                  absolute: bool = False) -> None:
    """In debug mode (``ctx.debug_domains``) reveal the operand and raise
    ``FloatingPointError`` when an element leaves ``[lo, hi]`` (``|x|``
    with ``absolute``). Revealing is a deliberate breach of privacy, for
    debugging only; by default nothing is checked and an operand outside
    the domain gives a silently wrong result, as in the reference."""
    if not ctx.debug_domains:
        return
    v = fixed.decode(S.reconstruct(x), ctx.frac_bits)
    if absolute:
        v = v.abs()
    nbad = int(((v < lo) | (v > hi)).sum())
    if nbad:
        rng = "|x|" if absolute else "x"
        raise FloatingPointError(
            f"mpc.functions.{fn_name}: {nbad} element(s) have {rng} outside the "
            f"approximation domain [{lo:g}, {hi:g}] (observed [{float(v.min()):g}, "
            f"{float(v.max()):g}]); the result would be silently wrong")


def _enc(ctx, c) -> torch.Tensor:
    return fixed.encode(c, ctx.frac_bits)


def _enc_int(ctx, c: float) -> int:
    return int(fixed.encode(c, ctx.frac_bits))


def add_public(ctx, x: AShare, c) -> AShare:
    """x + public float c."""
    return S.add_public(x, _enc_int(ctx, c))


def _truncate(x: AShare, bits: int) -> AShare:
    return AShare(fixed.truncate_shares(x.data, bits))


def mul_public(ctx, x: AShare, c: float) -> AShare:
    """x * public float c: one local product and one truncation."""
    return _truncate(S.mul_public(x, _enc_int(ctx, c)), ctx.frac_bits)


def div_public_int(ctx, x: AShare, n: int) -> AShare:
    """x / n for a public positive integer n, to a few units in the last
    place: n = 2^a m with m odd; a share-local shift by a + k, where 2^k >
    m, then the product with ``round(2^(f + k) / m)`` (at least 2^f, so its
    rounding is below 2^-(f+1) relative) and a shift by f. The values
    shifted stay near |x / n| 2^(2f), far below 2^63."""
    a = (n & -n).bit_length() - 1
    m = n >> a
    k = m.bit_length() if m > 1 else 0
    y = _truncate(x, a + k) if a + k else x
    if m > 1:
        y = _truncate(S.mul_public(y, round((1 << (ctx.frac_bits + k)) / m)), ctx.frac_bits)
    return y


def _mul(ctx, x: AShare, y: AShare, *, truncate: bool = True) -> AShare:
    z = beaver.mul(ctx.gen, x, y)
    return _truncate(z, ctx.frac_bits) if truncate else z


def _matmul(ctx, x: AShare, y: AShare) -> AShare:
    """Batched (..., n, n) products, one Beaver matmul a matrix."""
    if x.ndim == 2:
        return _truncate(beaver.matmul(ctx.gen, x, y), ctx.frac_bits)
    xs = x.data.reshape(2, -1, *x.shape[-2:])
    ys = y.data.reshape(2, -1, *y.shape[-2:])
    out = [_matmul(ctx, AShare(xs[:, i]), AShare(ys[:, i])).data for i in range(xs.shape[1])]
    return AShare(torch.stack(out, 1).reshape(2, *x.shape[:-1], y.shape[-1]))


def _div_pow2(x: AShare, bits: int) -> AShare:
    """x / 2**bits: a share-local arithmetic shift (error <= 1 ulp)."""
    return _truncate(x, bits)


def sign_int(ctx, x: AShare) -> AShare:
    """Integer (not fixed-point) shares of sign(x) in {-1, +1}; x == 0 maps
    to +1."""
    return S.add_public(S.mul_public(ctx.sign_shares(x), -2), 1)


def sign(ctx, x: AShare) -> AShare:
    """Fixed-point-encoded sign(x)."""
    return S.mul_public(sign_int(ctx, x), 1 << ctx.frac_bits)


def ge_zero_int(ctx, x: AShare) -> AShare:
    """Integer shares of 1{x >= 0}."""
    return S.add_public(S.neg(ctx.sign_shares(x)), 1)


# ------------------------------------------------------ pow / exp / log

def pow(ctx, x: AShare, power: int) -> AShare:  # noqa: A001
    """Integer power by square-and-multiply."""
    if power < 0:
        raise ValueError("Negative integer powers are not allowed.")
    if power == 0:
        return S.make_public(torch.full(tuple(x.shape), 1 << ctx.frac_bits, dtype=torch.int64,
                                        device=x.data.device))
    base, result = x, None
    while power > 0:
        if power % 2 == 1:
            result = base if result is None else _mul(ctx, result, base)
        power //= 2
        if power:
            base = _mul(ctx, base, base)
    return result


def exp(ctx, x: AShare, iterations: int = 8) -> AShare:
    """The limit ``exp(x) = (1 + x / 2^d)^(2^d)``, ``d = iterations``; for x
    in [-2^d, ~8]."""
    _domain_check(ctx, x, -(2.0 ** iterations), 8.0, "exp")
    return _exp_unchecked(ctx, x, iterations)


def _exp_unchecked(ctx, x: AShare, iterations: int = 8) -> AShare:
    """``exp`` without the domain check, for the internal callers whose
    operands leave the domain only to underflow toward 0."""
    y = add_public(ctx, _div_pow2(x, iterations), 1.0)
    for _ in range(iterations):
        y = _mul(ctx, y, y)
    return y


def log(ctx, x: AShare, iterations: int = 2, exp_iterations: int = 8) -> AShare:
    """Natural log by 6th-order Householder iterations on ``1 - x exp(-y)``
    from ``y_0 = x/31 + 1.59 - 20 exp(-2x - 1.4)``; for x in ~[1e-3, 2e2]."""
    _domain_check(ctx, x, 1e-3, 2e2, "log")
    e0 = _exp_unchecked(ctx, add_public(ctx, S.mul_public(x, -2), -1.4),
                        iterations=exp_iterations)
    y = S.add(mul_public(ctx, x, 1.0 / 31.0), add_public(ctx, mul_public(ctx, e0, -20.0), 1.59))
    one = _enc_int(ctx, 1.0)
    for _ in range(iterations):
        ey = _exp_unchecked(ctx, S.neg(y), iterations=exp_iterations)
        h1 = S.add_public(S.neg(_mul(ctx, x, ey)), one)
        h2 = _mul(ctx, h1, h1)
        h3 = _mul(ctx, h2, h1)
        h4 = _mul(ctx, h2, h2)
        h5 = _mul(ctx, h4, h1)
        # 1 + h/2 + h^2/3 + h^3/4 + h^4/5 + h^5/6
        series = S.add_public(
            S.add(S.add(mul_public(ctx, h1, 1 / 2), mul_public(ctx, h2, 1 / 3)),
                  S.add(S.add(mul_public(ctx, h3, 1 / 4), mul_public(ctx, h4, 1 / 5)),
                        mul_public(ctx, h5, 1 / 6))),
            one)
        y = S.sub(y, _mul(ctx, h1, series))
    return y


# ------------------------------------------------- reciprocal / rsqrt

def reciprocal(ctx, x: AShare, method: str = "nr", nr_iters: int = 10) -> AShare:
    """1 / x.

    - ``nr``: Newton-Raphson ``r <- 2r - r^2 |x|`` from ``3 exp(0.5 - |x|)
      + 0.003``, the sign put back at the end; |x| in ~[2^-7, 120].
    - ``newton``: the reference's 80 damped steps with C = 20, whose fixed
      point is ``a x^2 = 1``: it converges to ``a^(-1/2)``, kept as the
      reference has it; x in (0, ~40).
    - ``log``: ``exp(-log(|x|))`` with the sign put back.
    """
    method = method.lower()
    if method == "nr":
        _domain_check(ctx, x, 2.0 ** -7, 120.0, "reciprocal", absolute=True)
        s = sign_int(ctx, x)
        ax = beaver.mul(ctx.gen, x, s)  # an integer factor: no truncation
        r = add_public(ctx, S.mul_public(_exp_unchecked(ctx, add_public(ctx, S.neg(ax), 0.5)),
                                         3), 0.003)
        for _ in range(nr_iters):
            # r x first: it converges to 1, so its truncation keeps the
            # fractional bits that r * r would lose at x ~ 100
            rx = _mul(ctx, r, ax)
            r = S.sub(S.mul_public(r, 2), _mul(ctx, r, rx))
        return beaver.mul(ctx.gen, r, s)
    if method == "newton":
        _domain_check(ctx, x, 1e-4, 40.0, "reciprocal[newton]")
        C = 20
        y = S.add_public(S.neg(x), _enc_int(ctx, C + 1))
        r = mul_public(ctx, y, 1.0 / C)
        for _ in range(79):
            y = S.add_public(S.neg(_mul(ctx, x, _mul(ctx, r, r))), _enc_int(ctx, C + 1))
            r = mul_public(ctx, _mul(ctx, y, r), 1.0 / C)
        return r
    if method == "log":
        s = sign_int(ctx, x)
        ax = beaver.mul(ctx.gen, x, s)
        return beaver.mul(ctx.gen, _exp_unchecked(ctx, S.neg(log(ctx, ax))), s)
    raise ValueError(f"Invalid method {method} given for reciprocal function")


def div(ctx, x: AShare, y: AShare, method: str = "reciprocal", **kw) -> AShare:
    """Fixed-point ``x / y`` with a private divisor.

    - ``reciprocal``: ``x * reciprocal(y)``.
    - ``securenn``: SecureNN's exact long division of ``|x| << frac_bits``
      by ``|y|``, the sign put back by one product; |x| < 2^14 at 16
      fractional bits (the numerator's headroom).
    """
    if method == "reciprocal":
        return _mul(ctx, x, reciprocal(ctx, y, **kw))
    if method == "securenn":
        from primia_tpu_torch.mpc import securenn

        _domain_check(ctx, x, 0.0, 2.0 ** 14, "div[securenn]", absolute=True)
        sx = sign_int(ctx, x)
        sy = sign_int(ctx, y)
        ax = beaver.mul(ctx.gen, x, sx)
        ay = beaver.mul(ctx.gen, y, sy)
        q = securenn.division(ctx.gen, S.mul_public(ax, 1 << ctx.frac_bits), ay, **kw)
        return beaver.mul(ctx.gen, q, beaver.mul(ctx.gen, sx, sy))
    raise ValueError(f"unknown div method {method!r}")


def maxpool(ctx, x: AShare):
    """(max, argmax index) over the flattened tensor, in fixed rounds."""
    return max(ctx, x), argmax(ctx, x)


def maxpool_deriv(ctx, x: AShare) -> AShare:
    """Integer shares of the one-hot of the flattened max, shaped like x."""
    return argmax(ctx, x, one_hot=True)


def inverse_sqrt(ctx, x: AShare, iterations: int = 7) -> AShare:
    """rsqrt(x) by Newton ``y <- y (3 - x y^2) / 2`` from ``y_0 = 2.2
    exp(-(x/2 + 0.2)) + 0.2 - x/1024``; for x in ~[1e-2, 200]."""
    _domain_check(ctx, x, 1e-2, 200.0, "inverse_sqrt")
    e = _exp_unchecked(ctx, S.neg(add_public(ctx, _div_pow2(x, 1), 0.2)))
    y = add_public(ctx, S.sub(S.add(S.mul_public(e, 2), mul_public(ctx, e, 0.2)),
                              _div_pow2(x, 10)), 0.2)
    three = _enc_int(ctx, 3.0)
    for _ in range(iterations):
        xy2 = _mul(ctx, x, _mul(ctx, y, y))
        y = _div_pow2(_mul(ctx, y, S.add_public(S.neg(xy2), three)), 1)
    return y


def sqrt(ctx, x: AShare, iterations: int = 7) -> AShare:
    """sqrt(x) = x rsqrt(x)."""
    return _mul(ctx, x, inverse_sqrt(ctx, x, iterations))


def inverse(ctx, x: AShare, iterations: int = 8) -> AShare:
    """Newton-Schulz inverse of (batches of) square matrices: ``inv <- 2 inv
    - inv x inv`` from ``0.1 I``."""
    if x.ndim < 2 or x.shape[-1] != x.shape[-2]:
        raise ValueError("inverse needs batches of square matrices")
    eye = torch.eye(x.shape[-1], dtype=torch.float64, device=x.data.device) * 0.1
    inv = S.make_public(fixed.encode(eye.expand(tuple(x.shape)), ctx.frac_bits))
    for _ in range(iterations):
        inv = S.sub(S.mul_public(inv, 2), _matmul(ctx, _matmul(ctx, inv, x), inv))
    return inv


# ------------------------------------------------------ sigmoid / tanh

def _chebyshev_series(fn, width: float, terms: int) -> np.ndarray:
    """Chebyshev coefficients of ``fn`` on [-width, width] (public)."""
    n = np.arange(terms, dtype=np.float64)
    xs = width * np.cos((n + 0.5) * np.pi / terms)
    cos_t = np.cos(np.outer(n, n + 0.5) * np.pi / terms)
    return (2.0 / terms) * (cos_t @ fn(xs))


def _tanh_chebyshev(ctx, x: AShare, maxval: int = 6, terms: int = 32) -> AShare:
    """tanh by a truncated odd Chebyshev series on [-maxval, maxval],
    clamped to +-1 outside; one comparison batch holds both gates."""
    coeffs = _chebyshev_series(np.tanh, maxval, terms)[1::2]
    y = mul_public(ctx, x, 1.0 / maxval)
    # odd Chebyshev polynomials by T_{n+2} = 2 T_2 T_n - T_{n-2}
    t2 = add_public(ctx, S.mul_public(_mul(ctx, y, y), 2), -1.0)
    polys = [y]
    if len(coeffs) > 1:
        polys.append(S.sub(S.mul_public(_mul(ctx, t2, y), 2), y))
    while len(polys) < len(coeffs):
        polys.append(S.sub(S.mul_public(_mul(ctx, t2, polys[-1]), 2), polys[-2]))
    # sum c_k T_k: the scale-2^{2f} products summed, truncated once
    cvec = _enc(ctx, torch.from_numpy(coeffs)).to(x.data.device)
    cvec = cvec.reshape((-1,) + (1,) * x.ndim)
    out = _truncate(AShare((S.stack(polys).data * cvec).sum(1)), ctx.frac_bits)
    # the gates: 1{x > maxval} = msb(maxval - x), 1{x < -maxval} = msb(x + maxval)
    v = _enc_int(ctx, float(maxval))
    gates = ctx.sign_shares(AShare(torch.stack(
        [S.add_public(S.neg(x), v).data, S.add_public(x, v).data], dim=1)))
    g_up, g_dn = AShare(gates.data[:, 0]), AShare(gates.data[:, 1])
    inside = S.add_public(S.neg(S.add(g_up, g_dn)), 1)
    clamped = S.mul_public(S.sub(g_up, g_dn), 1 << ctx.frac_bits)
    return S.add(beaver.mul(ctx.gen, out, inside), clamped)


def tanh(ctx, x: AShare, method: str = "chebyshev", **kw) -> AShare:
    if method == "chebyshev":
        return _tanh_chebyshev(ctx, x, **kw)
    if method == "sigmoid":
        return add_public(ctx, S.mul_public(sigmoid(ctx, S.mul_public(x, 2), "exp"), 2), -1.0)
    raise ValueError(f"unknown tanh method {method!r}")


def _sigmoid_exp(ctx, x: AShare) -> AShare:
    """``(sigmoid(|x|) - 0.5) sign(x) + 0.5``, ``sigmoid(|x|) = 1 / (1 +
    exp(-|x|))`` with a Newton-Raphson reciprocal on [1, 2]."""
    s = sign_int(ctx, x)
    ax = beaver.mul(ctx.gen, x, s)
    denom = add_public(ctx, _exp_unchecked(ctx, S.neg(ax)), 1.0)
    r = reciprocal(ctx, denom, "nr", nr_iters=6)
    return add_public(ctx, beaver.mul(ctx.gen, add_public(ctx, r, -0.5), s), 0.5)


def _sigmoid_maclaurin(ctx, x: AShare) -> AShare:
    """The reference's degree-5 fit on [-8, 8]: 0.5 + w1 x + w3 x^3 + w5
    x^5; its coefficients encoded with 16 extra bits (w5 would round 9%
    off at 2^16), the sum shifted down once."""
    w1, w3, w5 = 1.91204779e-01, -4.58667307e-03, 4.20690803e-05
    x2 = _mul(ctx, x, x)
    x3 = _mul(ctx, x2, x)
    x5 = _mul(ctx, x3, x2)
    xb = 16
    cw = lambda w: int(fixed.encode(w, ctx.frac_bits + xb))  # noqa: E731
    acc = x.data * cw(w1) + x3.data * cw(w3) + x5.data * cw(w5)
    return add_public(ctx, _truncate(AShare(acc), ctx.frac_bits + xb), 0.5)


def sigmoid(ctx, x: AShare, method: str = "chebyshev") -> AShare:
    """``chebyshev``: ``(tanh(x / 2) + 1) / 2``; ``exp``; ``maclaurin``."""
    if method == "chebyshev":
        return add_public(ctx, _div_pow2(_tanh_chebyshev(ctx, _div_pow2(x, 1)), 1), 0.5)
    if method == "exp":
        return _sigmoid_exp(ctx, x)
    if method == "maclaurin":
        return _sigmoid_maclaurin(ctx, x)
    raise ValueError(f"unknown sigmoid method {method!r}")


# ------------------------------------------- argmax / max / mean / var

def _pairwise_ge(ctx, x: AShare, axis: int) -> AShare:
    """Integer shares of 1{x_i >= every other element} along ``axis``,
    in two comparison batches; ties give several ones."""
    n = x.shape[axis]
    if n == 1:
        return S.make_public(torch.ones(tuple(x.shape), dtype=torch.int64, device=x.data.device))
    daxis = axis + 1  # the value axis in the (2, ...) stack
    diffs = torch.stack([x.data - torch.roll(x.data, i + 1, dims=daxis) for i in range(n - 1)],
                        dim=1)
    wins = AShare(ge_zero_int(ctx, AShare(diffs)).data.sum(1))
    return ge_zero_int(ctx, S.add_public(wins, -(n - 1)))


def argmax(ctx, x: AShare, axis: Optional[int] = None, one_hot: bool = False,
           keepdims: bool = False) -> AShare:
    """Share-space argmax: the one-hot (integer shares) with ``one_hot``,
    else fixed-point-encoded indices; ties sum their indices, as the
    reference's ``_one_hot_to_index``."""
    if axis is None:
        flat = S.reshape(x, (-1,))
        oh = _pairwise_ge(ctx, flat, 0)
        if one_hot:
            return S.reshape(oh, x.shape)
        idx = torch.arange(flat.shape[0], dtype=torch.int64, device=x.data.device)
        return S.mul_public(AShare((oh.data * idx).sum(1)), 1 << ctx.frac_bits)
    oh = _pairwise_ge(ctx, x, axis)
    if one_hot:
        return oh
    shp = [1] * x.ndim
    shp[axis] = x.shape[axis]
    idx = torch.arange(x.shape[axis], dtype=torch.int64, device=x.data.device).reshape(shp)
    return S.mul_public(AShare((oh.data * idx).sum(axis + 1, keepdim=keepdims)),
                        1 << ctx.frac_bits)


def argmin(ctx, x: AShare, **kw) -> AShare:
    return argmax(ctx, S.neg(x), **kw)


def max(ctx, x: AShare, axis: Optional[int] = None,  # noqa: A001
        keepdims: bool = False) -> AShare:
    """max through the one-hot; the product with integer bits needs no
    truncation."""
    if axis is None:
        flat = S.reshape(x, (-1,))
        prod = beaver.mul(ctx.gen, flat, _pairwise_ge(ctx, flat, 0))
        return AShare(prod.data.sum(1))
    prod = beaver.mul(ctx.gen, x, _pairwise_ge(ctx, x, axis))
    return AShare(prod.data.sum(axis + 1, keepdim=keepdims))


def min(ctx, x: AShare, **kw) -> AShare:  # noqa: A001
    return S.neg(max(ctx, S.neg(x), **kw))


def mean(ctx, x: AShare, axis: Optional[int] = None, keepdims: bool = False) -> AShare:
    """A local sum and one exact division by the public count."""
    if axis is None:
        n = math.prod(x.shape)
        summed = x.data.reshape(2, -1).sum(1)
        if keepdims:
            summed = summed.reshape((2,) + (1,) * x.ndim)
    else:
        n = x.shape[axis]
        summed = x.data.sum(axis + 1, keepdim=keepdims)
    return div_public_int(ctx, AShare(summed), n)


def var(ctx, x: AShare, axis: Optional[int] = None, unbiased: bool = False,
        keepdims: bool = False) -> AShare:
    """The mean of squared deviations; ``unbiased`` rescales by n / (n - 1)."""
    mu = mean(ctx, x, axis, keepdims=True)
    d = S.sub(x, mu)
    n = math.prod(x.shape) if axis is None else x.shape[axis]
    out = mean(ctx, _mul(ctx, d, d), axis, keepdims=keepdims)
    if unbiased:
        out = mul_public(ctx, out, n / (n - 1))
    return out
