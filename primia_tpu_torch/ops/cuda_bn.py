"""Train-mode batch norm on the card (K8 and the passes around it): three
launches a direction.

Port of ``primia_tpu/ops/pallas_bn.py``. The CUDA kernels live in
``primia_tpu_torch/csrc/bn.cu``; its header note names the TPU kernels
the sums replace (``_sums_kernel``/``_gsums_kernel`` of ``_run_reduce``
and their batch-minor twins of ``_run_reduce_bm``) and states the bounds.
This module holds their wrappers, their plain PyTorch versions and
:func:`bn_train`, the ``torch.autograd.Function`` counterpart of the JAX
package's ``custom_vjp``:

- forward: :func:`channel_partials` (the sums, K8), :func:`bn_finalize`
  (mean, variance, the normalising coefficients and the running
  statistics' update) and :func:`bn_apply` (y);
- backward: :func:`grad_channel_partials` (the gradient sums, K8),
  :func:`bn_grad_finalize` (the gamma and beta gradients and dx's
  coefficients) and :func:`bn_dx`.

The TPU lays the sums out two ways for its lanes (row-major, and a
batch-minor view for C < 128); here every activation is ``channels_last``,
so the kernels read one (N*H*W, C) matrix, rows contiguous. The wrappers
check the layout that arrives, the gradient in the backward included:
``layout_copies`` counts each operand they had to copy into
``channels_last`` first (PyTorch's copy kernel, in a profile).

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel (counted in ``_build.launches``) or raises. The
plain versions compute in
``pallas_bn.py``'s order; on the card the kernels round every step as
those PyTorch ops do there.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from primia_tpu_torch.ops._build import declare, launch, sm_count
from primia_tpu_torch.ops.numerics import div

_vp, _ci, _ll, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
declare("bn", {"bn_sums": [_vp, _vp, _ll, _ci, _ci],
               "bn_finalize": [_vp, _ci, _ci, _vp, _vp, _cf, _cf, _vp, _vp, _cf, _cf, _cf, _vp],
               "bn_apply": [_vp, _vp, _vp, _vp, _ll, _ci, _ci],
               "bn_grad_sums": [_vp, _vp, _vp, _ll, _ci, _ci],
               "bn_grad_finalize": [_vp, _ci, _ci, _vp, _vp, _vp, _cf, _vp],
               "bn_dx": [_vp, _vp, _vp, _vp, _vp, _vp, _ll, _ci, _ci]})
layout_copies = {"bn_sums": 0, "bn_grad_sums": 0}

_THREADS = 256
_UNROLL = 4
_SUMS_PASSES = 4  # unrolled passes a sums block makes at least, where the rows allow
_SUMS_WAVES = 4  # sums blocks an SM, at most
_PASS_WAVES = 8  # elementwise blocks an SM, at most

# rows of bn_finalize's (7, C) and bn_grad_finalize's (6, C) outputs
STATS = ("s1", "s2", "mean", "var", "r", "inv", "off")
GRAD_COEFS = ("S1", "S2", "dgamma", "A", "B", "D")


def use_pallas_bn() -> bool:
    """``PRIMIA_PALLAS_BN=1`` routes every train-mode batch norm of a 4-D
    bfloat16 activation through :func:`bn_train` (``nn/core.py:Norm``). The
    JAX package honours the switch only on a TPU; the port honours it on
    every device: on CUDA it launches the kernels, on the CPU it runs their
    plain versions."""
    return os.environ.get("PRIMIA_PALLAS_BN", "0") == "1"


def _channels_last(t: torch.Tensor, name: Optional[str]) -> torch.Tensor:
    """A (N, C, H, W) or (R, C) bfloat16 tensor laid out as its (rows, C)
    matrix, rows contiguous: itself where it is, otherwise a copy, counted
    under ``name`` (None: not counted)."""
    if t.dtype != torch.bfloat16 or t.dim() not in (2, 4):
        raise ValueError(f"expected a (N, C, H, W) or (R, C) bfloat16 tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    fmt = torch.channels_last if t.dim() == 4 else torch.contiguous_format
    if not t.is_contiguous(memory_format=fmt):
        if name is not None:
            layout_copies[name] += 1
        t = t.contiguous(memory_format=fmt)
    return t


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The (rows, C) matrix view of a :func:`_channels_last` tensor."""
    return t.permute(0, 2, 3, 1).reshape(-1, t.shape[1]) if t.dim() == 4 else t


def _blocks(rows: int, C: int, device: torch.device, sums: bool) -> int:
    """Blocks for a kernel that walks ``rows`` rows of C channels, an
    unrolled pass of a block covering ``256 / (C/8) * 4`` rows. An
    elementwise pass takes one block a pass, at most 8 an SM (2,048
    threads). The sums take whole waves of one block an SM, at most 4, as
    many as give each block 4 passes: fewer partials for a small
    activation (layer4's 9,800 rows, 613 passes, take one wave)."""
    if C % 8 or C > 8 * _THREADS:
        raise ValueError(f"the BN kernels take C a multiple of 8, at most {8 * _THREADS}; "
                         f"got {C}")
    passes = -(-rows // ((_THREADS // (C // 8)) * _UNROLL))
    sms = sm_count(device)
    if not sums:
        return max(1, min(passes, sms * _PASS_WAVES))
    waves = max(1, min(_SUMS_WAVES, passes // (sms * _SUMS_PASSES)))
    return max(1, min(passes, sms * waves))


def _cuda(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise RuntimeError(f"the BN kernels run on CPU or CUDA tensors, not {t.device}")
        if t.device != ts[0].device:
            raise ValueError(f"operands on {t.device} and {ts[0].device}")


def _vector(v: torch.Tensor, C: int, what: str) -> None:
    """A (C,) float32 contiguous per-channel vector, 16-byte aligned (the
    kernels read eight channels' values as two float4 loads)."""
    if (v.dtype != torch.float32 or v.shape != (C,) or not v.is_contiguous()
            or v.data_ptr() % 16):
        raise ValueError(f"{what}: expected a contiguous, 16-byte aligned ({C},) float32 "
                         f"vector, got {tuple(v.shape)} {v.dtype}")


def _row(t: torch.Tensor, k: int) -> int:
    """The address of row ``k`` of a contiguous (rows, C) float32 tensor."""
    return t.data_ptr() + 4 * k * t.shape[1]


# The launches below take operands their callers have checked: the public
# wrappers each check their own, bn_train checks a direction's once.

def _sums(name: str, *ts: torch.Tensor) -> torch.Tensor:
    x = ts[-1]
    C = x.shape[1]
    rows = x.numel() // C
    nblocks = _blocks(rows, C, x.device, sums=True)
    partial = torch.empty((nblocks, 2, C), dtype=torch.float32, device=x.device)
    launch("bn", name, x.device, *(t.data_ptr() for t in ts), partial.data_ptr(), rows, C,
           nblocks)
    return partial


def _finalize(partial, gamma, beta, n, eps, running_mean, running_var, momentum):
    C = partial.shape[2]
    stats = torch.empty((len(STATS), C), dtype=torch.float32, device=partial.device)
    rm, rv = ((None, None) if running_mean is None
              else (running_mean.data_ptr(), running_var.data_ptr()))
    m = momentum
    launch("bn", "bn_finalize", partial.device, partial.data_ptr(), partial.shape[0], C,
           gamma.data_ptr(), beta.data_ptr(), float(n), eps, rm, rv, 1 - m, m,
           m * n / max(n - 1, 1), stats.data_ptr())
    return stats


def _apply(x: torch.Tensor, inv: int, off: int) -> torch.Tensor:
    C = x.shape[1]
    rows = x.numel() // C
    y = torch.empty_like(x)
    launch("bn", "bn_apply", x.device, x.data_ptr(), inv, off, y.data_ptr(), rows, C,
           _blocks(rows, C, x.device, sums=False))
    return y


def _grad_finalize(partial, gamma: int, mean: int, r: int, n: int) -> torch.Tensor:
    C = partial.shape[2]
    coef = torch.empty((len(GRAD_COEFS), C), dtype=torch.float32, device=partial.device)
    launch("bn", "bn_grad_finalize", partial.device, partial.data_ptr(), partial.shape[0], C,
           gamma, mean, r, float(n), coef.data_ptr())
    return coef


def _dx(g: torch.Tensor, x: torch.Tensor, A: int, B: int, D: int) -> torch.Tensor:
    C = x.shape[1]
    rows = x.numel() // C
    dx = torch.empty_like(x)
    launch("bn", "bn_dx", x.device, g.data_ptr(), x.data_ptr(), A, B, D, dx.data_ptr(), rows,
           C, _blocks(rows, C, x.device, sums=False))
    return dx


# --------------------------------------------------------- the sums (K8)

def channel_sums_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2) per channel in float32, in plain PyTorch."""
    xf = _rows(_channels_last(x, None)).float()
    return xf.sum(0), (xf * xf).sum(0)


def grad_channel_sums_plain(g: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum g, sum g*x) per channel in float32, in plain PyTorch."""
    gf = _rows(_channels_last(g, None)).float()
    xf = _rows(_channels_last(x, None)).float()
    return gf.sum(0), (gf * xf).sum(0)


def channel_partials(x: torch.Tensor) -> torch.Tensor:
    """K8: per-channel (sum x, sum x^2) of the bfloat16 ``x`` over every
    axis but the channel (dim 1 of a 4-D tensor, the last of a 2-D one),
    float32, in one read: ``pallas_bn.py:channel_sums``. Returns
    (blocks, 2, C) partials whose sum over the blocks is the sums: one
    per block of the kernel on the card, one on the CPU."""
    if x.device.type == "cpu":
        return torch.stack(channel_sums_plain(x))[None]
    _cuda(x)
    return _sums("bn_sums", _channels_last(x, "bn_sums"))


def grad_channel_partials(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K8: per-channel (sum g, sum g*x), float32, in one read of the
    bfloat16 pair: ``pallas_bn.py:grad_channel_sums``, as partials."""
    if g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g {tuple(g.shape)} on {g.device} and x {tuple(x.shape)} on "
                         f"{x.device} differ")
    if x.device.type == "cpu":
        return torch.stack(grad_channel_sums_plain(g, x))[None]
    _cuda(g, x)
    return _sums("bn_grad_sums", _channels_last(g, "bn_grad_sums"),
                 _channels_last(x, "bn_grad_sums"))


def channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum x, sum x^2): :func:`channel_partials` summed over its blocks
    (on the card by PyTorch; the batch norm's own path sums them in
    :func:`bn_finalize`)."""
    return tuple(channel_partials(x).sum(0))


def grad_channel_sums(g: torch.Tensor, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum g, sum g*x): :func:`grad_channel_partials` summed likewise."""
    return tuple(grad_channel_partials(g, x).sum(0))


def _check_partials(partial: torch.Tensor) -> int:
    if partial.dtype != torch.float32 or partial.dim() != 3 or partial.shape[1] != 2:
        raise ValueError(f"expected (blocks, 2, C) float32 partials, got "
                         f"{tuple(partial.shape)} {partial.dtype}")
    return partial.shape[2]


# ------------------------------------------------------------- forward

def bn_finalize_plain(sums: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, n: int,
                      eps: float, running_mean: Optional[torch.Tensor] = None,
                      running_var: Optional[torch.Tensor] = None,
                      momentum: float = 0.1) -> torch.Tensor:
    """:func:`bn_finalize` from the (2, C) sums, in plain PyTorch."""
    s1, s2 = sums[0], sums[1]
    mean = div(s1, float(n))
    var = torch.addcmul(div(s2, float(n)), mean, mean, value=-1.0).clamp_min_(0.0)
    r = torch.rsqrt(var + eps)
    inv = gamma.float() * r
    off = torch.addcmul(beta.float(), mean, inv, value=-1.0)
    if running_mean is not None:
        # primia_tpu/nn/core.py:batch_norm (train=True): the unbiased
        # variance, (1 - m) * old + m * batch
        m = momentum
        with torch.no_grad():
            running_mean.mul_(1 - m).add_(mean, alpha=m)
            running_var.mul_(1 - m).add_(var, alpha=m * n / max(n - 1, 1))
    return torch.stack([s1, s2, mean, var, r, inv, off])


def bn_finalize(partial: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, n: int,
                eps: float, running_mean: Optional[torch.Tensor] = None,
                running_var: Optional[torch.Tensor] = None,
                momentum: float = 0.1) -> torch.Tensor:
    """The forward's statistics from the sums' partials: sums them in a
    fixed order, then mean, the biased var, r = rsqrt(var + eps), inv =
    gamma r and off = beta - mean inv (``pallas_bn.py:_bn_fwd_impl``) over
    ``n`` values a channel; returns them as the rows of a (7, C) float32
    tensor (``STATS``). Given ``running_mean`` and ``running_var``
    (float32), updates them in place with momentum ``momentum`` and the
    unbiased variance, as ``primia_tpu/nn/core.py:batch_norm`` does."""
    C = _check_partials(partial)
    if (running_mean is None) != (running_var is None):
        raise ValueError("give both running statistics or neither")
    if partial.device.type == "cpu":
        return bn_finalize_plain(partial.sum(0), gamma, beta, n, eps, running_mean,
                                 running_var, momentum)
    _check_params(partial, C, gamma, beta, running_mean, running_var)
    return _finalize(partial.contiguous(), gamma, beta, n, eps, running_mean, running_var,
                     momentum)


def _check_params(t, C, gamma, beta, running_mean=None, running_var=None) -> None:
    running = () if running_mean is None else (running_mean, running_var)
    _cuda(t, gamma, beta, *running)
    for v, what in ((gamma, "gamma"), (beta, "beta"), *((r, "running") for r in running)):
        _vector(v, C, what)


def bn_apply_plain(x: torch.Tensor, inv: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """:func:`bn_apply` in plain PyTorch."""
    return torch.addcmul(_chan(off), x, _chan(inv), out=torch.empty_like(x))


def bn_apply(x: torch.Tensor, inv: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """y = x * inv + off per channel, in float32 (one fused multiply-add,
    as PyTorch's addcmul gives :func:`bn_apply_plain` on the card),
    rounded once to x's dtype (bfloat16), as ``F.batch_norm`` rounds it
    (the JAX package rounds inv and off to bfloat16 first,
    ``pallas_bn.py:261``). y is ``channels_last``."""
    if x.device.type == "cpu":
        return bn_apply_plain(x, inv, off)
    _cuda(x, inv, off)
    x = _channels_last(x, None)
    _vector(inv, x.shape[1], "inv")
    _vector(off, x.shape[1], "off")
    return _apply(x, inv.data_ptr(), off.data_ptr())


# ------------------------------------------------------------ backward

def bn_grad_finalize_plain(sums: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                           r: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`bn_grad_finalize` from the (2, C) gradient sums, in plain
    PyTorch."""
    S1, S2 = sums[0], sums[1]
    dgamma = torch.addcmul(S2, mean, S1, value=-1.0).mul_(r)
    # dx = gamma r (g - S1/n - xhat dgamma/n), xhat = (x - mean) r,
    #    = A g + B x + D with per-channel A = gamma r, B = -A r m and
    #    D = A (r m mean - S1/n), m = dgamma/n (pallas_bn.py:_bn_bwd)
    A = gamma.float() * r
    rm = r * div(dgamma, float(n))
    B = torch.mul(A, rm).neg_()
    D = torch.addcmul(div(S1, float(n)), rm, mean, value=-1.0).mul_(A).neg_()
    return torch.stack([S1, S2, dgamma, A, B, D])


def bn_grad_finalize(partial: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                     r: torch.Tensor, n: int) -> torch.Tensor:
    """The backward's coefficients from the gradient sums' partials: sums
    them in a fixed order, then dgamma = r (S2 - mean S1), dbeta = S1 and
    dx's per-channel A, B, D (``pallas_bn.py:_bn_bwd``), as the rows of a
    (6, C) float32 tensor (``GRAD_COEFS``)."""
    C = _check_partials(partial)
    if partial.device.type == "cpu":
        return bn_grad_finalize_plain(partial.sum(0), gamma, mean, r, n)
    _cuda(partial, gamma, mean, r)
    for v, what in ((gamma, "gamma"), (mean, "mean"), (r, "r")):
        _vector(v, C, what)
    return _grad_finalize(partial.contiguous(), gamma.data_ptr(), mean.data_ptr(), r.data_ptr(),
                          n)


def bn_dx_plain(g: torch.Tensor, x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                D: torch.Tensor) -> torch.Tensor:
    """:func:`bn_dx` in plain PyTorch."""
    return torch.addcmul(torch.addcmul(_chan(D), g, _chan(A)), x, _chan(B),
                         out=torch.empty_like(x))


def bn_dx(g: torch.Tensor, x: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
          D: torch.Tensor) -> torch.Tensor:
    """dx = A g + B x + D per channel, in float32 as PyTorch's addcmul
    gives :func:`bn_dx_plain` on the card (fma(x, B, fma(g, A, D))), and
    rounded once to x's dtype (bfloat16); ``channels_last``."""
    if g.shape != x.shape:
        raise ValueError(f"g {tuple(g.shape)} and x {tuple(x.shape)} differ")
    if x.device.type == "cpu":
        return bn_dx_plain(g, x, A, B, D)
    _cuda(g, x, A, B, D)
    g, x = _channels_last(g, None), _channels_last(x, None)
    for v, what in ((A, "A"), (B, "B"), (D, "D")):
        _vector(v, x.shape[1], what)
    return _dx(g, x, A.data_ptr(), B.data_ptr(), D.data_ptr())


# ------------------------------------------------------------ bn_train

def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


class _BnTrain(torch.autograd.Function):
    """On the card a direction's operands are checked once and its three
    kernels launched directly; on the CPU the wrappers run the plain
    versions."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, running_mean, running_var, momentum, ranks):
        n = x.numel() // x.shape[1]
        if x.device.type == "cuda":
            x = _channels_last(x, "bn_sums")
            _check_params(x, x.shape[1], gamma, beta, running_mean, running_var)
            partial = _sums("bn_sums", x)
        else:
            partial = channel_partials(x)
        if ranks is not None:
            partial, n = ranks.sum_(partial.sum(0, keepdim=True)), n * ranks.size
        if x.device.type == "cuda":
            stats = _finalize(partial, gamma, beta, n, eps, running_mean, running_var, momentum)
            y = _apply(x, _row(stats, 5), _row(stats, 6))
        else:
            stats = bn_finalize(partial, gamma, beta, n, eps, running_mean, running_var,
                                momentum)
            y = bn_apply(x, stats[5], stats[6])
        mean, var = stats[2], stats[3]
        ctx.ranks = ranks
        ctx.save_for_backward(x, gamma, stats)
        ctx.mark_non_differentiable(mean, var)
        # mean and var get no gradient: no zeros are made for them
        ctx.set_materialize_grads(False)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        if gy is None:  # y took no part in what is differentiated
            return (None,) * 8
        x, gamma, stats = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        if x.device.type == "cuda":
            if gy.shape != x.shape or gy.device != x.device:
                raise ValueError(f"gradient {tuple(gy.shape)} on {gy.device} for x "
                                 f"{tuple(x.shape)} on {x.device}")
            gy = _channels_last(gy, "bn_grad_sums")
            partial = _sums("bn_grad_sums", gy, x)
        else:
            partial = grad_channel_partials(gy, x)
        ranks = ctx.ranks
        if ranks is not None:
            # this rank's gamma and beta gradients; dx's coefficients from
            # the sums over every rank
            own = partial.sum(0)
            dgamma = torch.addcmul(own[1], stats[2], own[0], value=-1.0).mul_(stats[4])
            partial, n = ranks.sum_(own[None].clone()), n * ranks.size
        if x.device.type == "cuda":
            coef = _grad_finalize(partial, gamma.data_ptr(), _row(stats, 2), _row(stats, 4), n)
            dx = _dx(gy, x, _row(coef, 3), _row(coef, 4), _row(coef, 5))
        else:
            coef = bn_grad_finalize(partial, gamma, stats[2], stats[4], n)
            dx = bn_dx(gy, x, coef[3], coef[4], coef[5])
        if ranks is not None:
            return dx, dgamma.to(gamma.dtype), own[0].to(gamma.dtype), None, None, None, None, None
        return dx, coef[2].to(gamma.dtype), coef[0].to(gamma.dtype), None, None, None, None, None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float = 1e-5,
             running_mean: Optional[torch.Tensor] = None,
             running_var: Optional[torch.Tensor] = None,
             momentum: float = 0.1, ranks=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Train-mode batch norm of a (N, C, H, W) bfloat16 ``x``; returns
    (y, mean, biased var), y in x's dtype, mean and var float32 (not
    differentiated). ``pallas_bn.py:bn_train``, in three launches a
    direction on the card: forward the sums, :func:`bn_finalize` and
    :func:`bn_apply`; backward the gradient sums, :func:`bn_grad_finalize`
    and :func:`bn_dx`. Given the running statistics, the finalize updates
    them in place (momentum ``momentum``, the unbiased variance).

    ``ranks`` (``parallel/data_parallel.py``): the ranks that share the
    batch, each holding an equal number of its rows. Each direction's sums
    are then summed over them (``ranks.sum_``) between K8's launch and the
    finalize, so the statistics and dx are the whole batch's; gamma's and
    beta's gradients stay this rank's own."""
    return _BnTrain.apply(x, gamma, beta, eps, running_mean, running_var, momentum, ranks)
