"""DP-SGD: per-example clipping, Gaussian noise, the RDP accountant and the
parameter EMA — workload 4.

Port of ``primia_tpu/train/dp.py`` (reference ``train.py:326-334``,
torchdp's ``PrivacyEngine``): clip each example's gradient to
``max_grad_norm``, sum, add ``N(0, (noise_multiplier * max_grad_norm)^2 I)``
and divide by the batch's real examples. Both steps keep the contract of
the port's ``build_train_step``: ``step(gen, images_u8, labels, mask, lr)
-> loss``, so the local loop and every simulated federated node take them
through :func:`select_train_step`.

- :func:`build_dp_train_step`, the microbatched path: per-example
  gradients from ``torch.func.vmap(torch.func.grad(...))`` over
  ``functional_call`` of the model in eval mode, chunks of
  ``$PRIMIA_DP_MICROBATCH`` examples (default 8), the tail padded with mask
  0. With ``augment_multiplicity = K`` each example's gradient is the mean
  over K augmented views, before clipping (De et al. 2022); the
  augmentation runs once over the K x B stacked batch.
- :func:`build_ghost_dp_train_step`, the ghost-norm path: one forward that
  records each parameterised op's input, one backward to those ops'
  outputs with the parameters out of the graph, per-example gradient norms
  in closed form (sweep 1) and the clipped sum assembled from the same
  records (sweep 2). Per-example gradients exist only for the convs whose
  norms take the per-tap form, where they are the norm's own product.
- :func:`rdp_sampled_gaussian` and :func:`rdp_epsilon`, the
  subsampled-Gaussian RDP accountant, and :class:`ParameterEMA`.

The noise is one flat draw over every parameter, as the JAX package's
``_gaussian_tree_noise``: ``torch.randn(P, generator=gen)``, added to the
clipped sum, which lives in one flat float32 buffer whose views are the
leaves' gradients (one ``add_`` and one ``div_`` a step, not one a leaf).
``PRIMIA_DP_SECURE_NOISE=1`` makes the JAX package draw with Threefry
rather than the TPU's ``rbg`` generator. The port's draw comes from the
step's generator; on CUDA that is Philox-4x32-10 with a 64-bit seed, a
counter-based generator of Threefry's own Random123 family. So the switch
picks nothing here: both settings give the same draw, and a set switch
says so with a warning (on the CPU the generator is torch's mt19937).

Two faults of the JAX package (``ADVICE.md``) are not copied: the ghost
path keeps its clip factors and per-example tap gradients in float32 (the
JAX package rounds both to bfloat16), and a DP + EMA checkpoint keeps the
raw parameters beside the averaged ones (``train/loop.py``).
"""

from __future__ import annotations

import contextlib
import copy
import math
import os
import warnings
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch.nn.core import Conv, Norm, bn_fold, group_normalize
from primia_tpu_torch.ops.augment import AugmentConfig, build_augment_fn
from primia_tpu_torch.ops.cuda_wgrad import conv3x3_wgrad_v2, use_pallas_wgrad
from primia_tpu_torch.train import losses
from primia_tpu_torch.train.steps import (_class_weights, _full_f32, _on, build_train_step,
                                          resolve_compute_dtype)

# dense integer orders: the optimum usually sits at a small alpha for the
# subsampled Gaussian (primia_tpu/train/dp.py:39)
DEFAULT_ALPHAS = tuple(range(2, 65)) + (100, 128, 256)

# A conv whose output has at most this many pixels (T = Ho * Wo) takes its
# per-example norm in the T^2 gram form, ||G_i||^2 = <X_i X_i^T, D_i D_i^T>;
# a larger one the per-tap form, G_i = X_i^T D_i, kept for sweep 2 (the JAX
# package's ``ghost=T <= 256``). At 224 px: layer3 and layer4 (T = 196, 49)
# take the gram form; the stem, layer1 and layer2 (T = 12544, 3136, 784)
# the per-tap form.
GHOST_GRAM_MAX_T = 256


def _warn_secure_noise() -> None:
    """``PRIMIA_DP_SECURE_NOISE=1`` asks the JAX package for Threefry
    instead of the TPU's ``rbg`` for the DP noise; the port draws the same
    either way (module docstring), and says so."""
    if os.environ.get("PRIMIA_DP_SECURE_NOISE") == "1":
        warnings.warn("PRIMIA_DP_SECURE_NOISE=1 changes nothing in the port: the DP noise "
                      "already comes from the step's generator (Philox-4x32-10 with a 64-bit "
                      "seed on CUDA)", RuntimeWarning)


class FlatGrads:
    """The clipped sum in one flat float32 buffer, with a view shaped like
    each parameter (in ``params`` order) as its gradient."""

    def __init__(self, params: Sequence[torch.Tensor], device):
        offsets = np.cumsum([0] + [p.numel() for p in params])
        self.flat = torch.zeros(int(offsets[-1]), dtype=torch.float32, device=device)
        self.views = [self.flat[int(a):int(b)].view(p.shape)
                      for a, b, p in zip(offsets[:-1], offsets[1:], params)]

    def noise_and_average(self, gen: torch.Generator, sigma: float,
                          mask: torch.Tensor) -> List[torch.Tensor]:
        """``(sum + sigma * z) / max(sum(mask), 1)`` in place, ``z`` one
        flat N(0, 1) draw from ``gen``; returns the per-leaf views."""
        z = torch.randn(self.flat.numel(), generator=gen, device=self.flat.device,
                        dtype=torch.float32)
        self.flat.add_(z.mul_(sigma))
        self.flat.div_(torch.clamp(mask.sum(), min=1.0))
        return self.views


def _clip_factor(sq: torch.Tensor, clip: float, mask: torch.Tensor) -> torch.Tensor:
    """``min(1, clip / sqrt(sq + 1e-12)) * mask`` in float32 (a true
    quotient: ``clip / t`` would multiply by ``t``'s reciprocal)."""
    c = torch.full_like(sq, clip) / torch.sqrt(sq + 1e-12)
    return torch.clamp(c, max=1.0) * mask


def _pad_rows(t: torch.Tensor, pad: int) -> torch.Tensor:
    if not pad:
        return t
    return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])


def build_dp_train_step(model: nn.Module, optimizer, args, mean, std,
                        class_weights: Optional[np.ndarray] = None, device="cuda",
                        microbatch: Optional[int] = None) -> Callable:
    """The microbatched DP step (``primia_tpu/train/dp.py:build_dp_train_step``):
    ``step(gen, images_u8, labels, mask, lr) -> loss``.

    Augmentation, then per-example gradients in chunks of ``microbatch``
    examples (default ``$PRIMIA_DP_MICROBATCH`` or 8) against copies of
    the parameters in the compute dtype (bfloat16 on the card), the model in
    eval mode; squared norms, clip factors and the clipped sum in float32;
    the noise, the division by the real examples, ``optimizer.update``.
    The loss is the masked mean of the per-example losses.

    Under ``PRIMIA_PALLAS_WGRAD=1`` with bfloat16 compute and
    ``augment_multiplicity > 1`` an example's K views reach K7's
    ``autograd.Function`` (``nn/core.py:Conv``), whose ``vmap`` rule
    launches K7 once an example of the chunk, as the JAX package's ``vmap``
    batches its Pallas weight gradient.
    """
    from torch.func import functional_call, grad_and_value, vmap

    device = torch.device(device)
    if microbatch is None:
        microbatch = int(os.environ.get("PRIMIA_DP_MICROBATCH", 8))
    K = max(int(getattr(args, "augment_multiplicity", 1)), 1)
    cdtype = resolve_compute_dtype(args, device)
    _warn_secure_noise()
    in_channels = model.in_channels
    augment = build_augment_fn(AugmentConfig.from_args(args), mean, std, in_channels, device)
    w = _class_weights(args, class_weights, device)
    clip = float(args.max_grad_norm)
    sigma = float(args.noise_multiplier) * clip
    _full_f32(device)
    names, params = optimizer.names, optimizer.params
    buffers = dict(model.named_buffers())
    acc = FlatGrads(params, device)

    def ex_loss(p, xi, yi):
        # xi: one example's view, or its K views, which run as one batch:
        # the mean cross entropy's gradient is the mean over the views
        xb = xi if K > 1 else xi[None]
        logits = functional_call(model, (p, buffers), (xb,))
        return losses.cross_entropy(logits.float(), yi.expand(xb.shape[0]), weight=w)

    per_example = vmap(grad_and_value(ex_loss), in_dims=(None, 0, 0))

    def step(gen: torch.Generator, images_u8, labels, mask, lr: float) -> torch.Tensor:
        model.eval()
        u8 = _on(device, images_u8)
        labels = _on(device, labels, torch.long)
        mask = _on(device, mask, torch.float32)
        B = u8.shape[0]
        if K == 1:
            x = augment(gen, u8)
        else:
            # one augmentation pass over the K x B stack: independent draws
            # for every view, example-major, so (B, K, ...) is a view
            x = augment(gen, u8.repeat_interleave(K, 0))
            x = x.reshape(B, K, *x.shape[1:])
        x = x.to(cdtype)
        pc = {n: p.detach().to(cdtype) for n, p in zip(names, params)}
        mb = min(microbatch, B)
        n_chunks = -(-B // mb)
        pad = n_chunks * mb - B
        x, labels, mask_p = (_pad_rows(t, pad) for t in (x, labels, mask))
        acc.flat.zero_()
        loss_sum = torch.zeros((), dtype=torch.float32, device=device)
        for c in range(n_chunks):
            sl = slice(c * mb, (c + 1) * mb)
            gs, ls = per_example(pc, x[sl], labels[sl])
            g = torch.cat([gs[n].reshape(mb, -1) for n in names], 1).float()
            factor = _clip_factor(g.square().sum(1), clip, mask_p[sl])
            acc.flat.addmv_(g.t(), factor)
            loss_sum += (ls.float() * mask_p[sl]).sum()
        grads = acc.noise_and_average(gen, sigma, mask)
        optimizer.update(grads, lr)
        return loss_sum / torch.clamp(mask.sum(), min=1.0)

    return step


# ------------------------------------------------------- ghost-norm clipping

class _Record:
    """One parameterised op of the ghost forward: its kind, module, input
    ``x`` and output ``y`` (whose cotangent ``dy`` pass 1 fills in), and
    what sweep 1 leaves for sweep 2."""

    __slots__ = ("kind", "module", "x", "y", "dy", "mean", "r", "G", "ga", "gb")

    def __init__(self, kind, module, x, y, mean=None, r=None):
        self.kind, self.module, self.x, self.y = kind, module, x, y
        self.mean, self.r = mean, r
        self.dy = self.G = self.ga = self.gb = None


@contextlib.contextmanager
def ghost_capture(model: nn.Module, cdtype: torch.dtype):
    """For the block, every ``Conv``, ``Norm`` and ``nn.Linear`` of
    ``model`` runs on detached copies of its parameters in ``cdtype`` and
    appends a :class:`_Record` to the list this yields. Each op's output
    requires grad, so ``torch.autograd.grad`` to the outputs gives every
    op's per-example cotangent, and no weight gradient is computed. Convs
    are ``F.conv2d`` whatever ``PRIMIA_PALLAS_WGRAD`` says, as the JAX
    package's ghost engine calls the raw conv. Group norm records its affine
    with ``x_hat`` as the input; eval-mode batch norm records its folded
    affine with the running mean and ``rsqrt(var + eps)`` (JAX ``bn_meta``),
    which chain the affine's gradient back to gamma and beta. A conv with a
    bias adds it inside its record: the bias's cotangent is the conv's
    output cotangent (the JAX package's separate ``bias_add`` record)."""
    records: List[_Record] = []

    def tap(kind, m, x, y, **meta):
        if not y.requires_grad:
            y.requires_grad_()
        records.append(_Record(kind, m, x, y, **meta))
        return y

    def conv(m, x):
        w = m.weight.detach().to(cdtype)
        y = F.conv2d(x, w, stride=m.stride, padding=m.padding)
        if m.bias is not None:
            y = y + m.bias.detach().to(y.dtype).reshape(1, -1, 1, 1)
        return tap("conv", m, x, y)

    def norm(m, x):
        gamma, beta = m.weight.detach().to(cdtype), m.bias.detach().to(cdtype)
        if m.kind == "group":
            xhat = group_normalize(x, eps=m.eps)
            return tap("affine", m, xhat, xhat * gamma.reshape(1, -1, 1, 1)
                       + beta.reshape(1, -1, 1, 1))
        f = bn_fold(gamma, beta, m.running_mean, m.running_var, m.eps)
        y = x * f["scale"].reshape(1, -1, 1, 1).to(x.dtype) \
            + f["offset"].reshape(1, -1, 1, 1).to(x.dtype)
        r = torch.rsqrt(m.running_var.float() + m.eps)
        return tap("bn", m, x, y, mean=m.running_mean.float(), r=r)

    def linear(m, x):
        b = None if m.bias is None else m.bias.detach().to(cdtype)
        return tap("linear", m, x, F.linear(x, m.weight.detach().to(cdtype), b))

    patched = []
    for m in model.modules():
        fn = conv if isinstance(m, Conv) else norm if isinstance(m, Norm) else \
            linear if isinstance(m, nn.Linear) else None
        if fn is not None:
            m.forward = (lambda f, mod: lambda x: f(mod, x))(fn, m)
            patched.append(m)
    try:
        yield records
    finally:
        for m in patched:
            del m.forward


def _channel_sums(x: torch.Tensor, dy: torch.Tensor):
    """Per-example (B, C) sums over the spatial axes of ``x * dy`` and
    ``dy``, in float32 (2-D inputs pass through)."""
    xf, df = x.float(), dy.float()
    if dy.dim() > 2:
        return (xf * df).sum((2, 3)), df.sum((2, 3))
    return xf * df, df


def _patches(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """``F.unfold``'s (B, C * kh * kw, T) patches of ``x`` in float32, rows
    in (channel, tap) order, built as one strided view and one copy
    (``F.unfold`` on the card launches an im2col kernel an example)."""
    xp = F.pad(x.float(), (padding,) * 4) if padding else x.float()
    B, C, Hp, Wp = xp.shape
    Ho, Wo = (Hp - kh) // stride + 1, (Wp - kw) // stride + 1
    sB, sC, sH, sW = xp.stride()
    view = xp.as_strided((B, C, kh, kw, Ho, Wo), (sB, sC, sH, sW, sH * stride, sW * stride),
                         xp.storage_offset())
    return view.reshape(B, C * kh * kw, Ho * Wo)


def _ghost_sq_norms(records: Sequence[_Record]) -> torch.Tensor:
    """Sweep 1 (``primia_tpu/train/dp.py:_ghost_layer_stats``): each
    example's squared norm of the whole parameter gradient, summed over
    the records, in float32; leaves ``G`` (per-tap convs), ``gb`` (conv
    biases, ``dy`` summed over H x W) and ``ga``/``gb`` (affines) on the
    records for sweep 2.

    A conv's patches are (B, K, T), K = cin * kh * kw (:func:`_patches`).
    With T <= :data:`GHOST_GRAM_MAX_T` its norm is the T^2 gram form
    ``<P^T P, D^T D>``; otherwise ``G = P D^T`` (B, K, cout), the
    per-example weight gradient, whose squares sum to the norm. The stem
    takes the per-tap form like any large-T conv: one unfold of its 3
    input channels (147 rows) and one product, which reads its
    cotangent once. The JAX package rewrites the stem as a 4x4 conv
    over 12 space-to-depth channels, a TPU layout the port does not
    have (``nn/resnet.py``); the norms are the same."""
    total = None
    for r in records:
        x, dy = r.x, r.dy
        if r.kind == "conv":
            m = r.module
            kh, kw = m.weight.shape[2:]
            B, cout = dy.shape[:2]
            pat = _patches(x, kh, kw, m.stride, m.padding)
            dyf = dy.float().reshape(B, cout, -1)
            if dyf.shape[2] <= GHOST_GRAM_MAX_T:
                sx = pat.transpose(1, 2) @ pat
                sd = dyf.transpose(1, 2) @ dyf
                sq = (sx * sd).sum((1, 2))
            else:
                r.G = pat @ dyf.transpose(1, 2)
                sq = r.G.square().sum((1, 2))
            if m.bias is not None:
                # an example's bias gradient: its cotangent summed over H x W
                r.gb = dyf.sum(2)
                sq = sq + r.gb.square().sum(-1)
        elif r.kind == "linear":
            ds = dy.float().square().sum(-1)
            sq = x.float().square().sum(-1) * ds
            if r.module.bias is not None:
                sq = sq + ds
        else:  # "affine" (group norm) or "bn": y = a * x + b channelwise
            ga, gb = _channel_sums(x, dy)
            if r.kind == "bn":
                # a = gamma r, b = beta - mean gamma r, so
                # g_gamma = r (g_a - mean g_b), g_beta = g_b
                ga = r.r * (ga - r.mean * gb)
            r.ga, r.gb = ga, gb
            sq = (ga.square() + gb.square()).sum(-1)
        total = sq if total is None else total + sq
    return total


def _ghost_weighted_grads(records: Sequence[_Record], factor: torch.Tensor):
    """Sweep 2 (``primia_tpu/train/dp.py:_ghost_weighted_grads``): for each
    record, ``(parameter, sum_i factor_i g_i)`` pairs. Examples are
    independent in the eval-mode forward, so example i's cotangent under
    loss weight ``factor_i`` is ``factor_i`` times its pass-1 cotangent:
    per-tap convs contract their ``G`` with the factors; a gram-form conv
    runs one weight gradient of the scaled cotangent, on K7
    (``conv3x3_wgrad_v2``) where the JAX package calls its kernel
    (``PRIMIA_PALLAS_WGRAD=1``, a 3x3/s1/p1 bfloat16 conv with
    128 <= cin, cout <= 256), else the library's
    (``torch.nn.grad.conv2d_weight``); the affines and the fc contract
    their sums, as does a conv's bias."""
    out = []
    for r in records:
        m = r.module
        if r.kind == "conv":
            if r.G is not None:
                co, ci, kh, kw = m.weight.shape
                gw = torch.einsum("b,bkc->ck", factor, r.G).reshape(co, ci, kh, kw)
            else:
                x, dy = r.x, r.dy
                dyc = (dy.float() * factor.reshape(-1, 1, 1, 1)).to(dy.dtype)
                ci, co = x.shape[1], m.weight.shape[0]
                if (m.weight.shape[2:] == (3, 3) and m.stride == 1 and m.padding == 1
                        and x.dtype == torch.bfloat16 and 128 <= ci <= 256
                        and 128 <= co <= 256 and use_pallas_wgrad()):
                    gw = conv3x3_wgrad_v2(x, dyc)
                else:
                    gw = torch.nn.grad.conv2d_weight(x, m.weight.shape, dyc, stride=m.stride,
                                                     padding=m.padding)
            out.append((m.weight, gw))
            if m.bias is not None:
                out.append((m.bias, factor @ r.gb))
        elif r.kind == "linear":
            df = r.dy.float()
            out.append((m.weight, df.t() @ (r.x.float() * factor[:, None])))
            if m.bias is not None:
                out.append((m.bias, factor @ df))
        else:
            out += [(m.weight, factor @ r.ga), (m.bias, factor @ r.gb)]
    return out


def build_ghost_dp_train_step(model: nn.Module, optimizer, args, mean, std,
                              class_weights: Optional[np.ndarray] = None,
                              device="cuda") -> Callable:
    """The ghost-norm DP step (``primia_tpu/train/dp.py:build_ghost_dp_train_step``):
    the contract and DP semantics of :func:`build_dp_train_step` at
    ``augment_multiplicity = 1``, with one forward and one backward pass.

    1. The forward under :func:`ghost_capture`, the model in eval mode, in
       the compute dtype; ``lvec`` the per-example cross entropy.
    2. ``torch.autograd.grad(lvec.sum(), outputs)``: every parameterised
       op's per-example output cotangent; the parameters are not in the
       graph, so no weight gradient runs.
    3. Sweep 1 (:func:`_ghost_sq_norms`), the clip factors in float32,
       sweep 2 (:func:`_ghost_weighted_grads`) into the flat buffer, noise,
       the division, ``optimizer.update``.

    Class weights drop out of a single example's hard-label cross entropy
    (``w_y ce / w_y``), as in the microbatched path."""
    device = torch.device(device)
    _warn_secure_noise()
    in_channels = model.in_channels
    augment = build_augment_fn(AugmentConfig.from_args(args), mean, std, in_channels, device)
    clip = float(args.max_grad_norm)
    sigma = float(args.noise_multiplier) * clip
    cdtype = resolve_compute_dtype(args, device)
    _full_f32(device)
    params = optimizer.params
    acc = FlatGrads(params, device)
    slot = {id(p): v for p, v in zip(params, acc.views)}

    def step(gen: torch.Generator, images_u8, labels, mask, lr: float) -> torch.Tensor:
        model.eval()
        x = augment(gen, _on(device, images_u8)).to(cdtype)
        labels = _on(device, labels, torch.long)
        mask = _on(device, mask, torch.float32)
        with torch.enable_grad(), ghost_capture(model, cdtype) as records:
            logits = model(x)
            logp = F.log_softmax(logits.float(), dim=1)
            lvec = -torch.gather(logp, 1, labels[:, None])[:, 0]
            dys = torch.autograd.grad(lvec.sum(), [r.y for r in records])
        with torch.no_grad():
            for r, dy in zip(records, dys):
                r.x, r.dy, r.y = r.x.detach(), dy, None
            lvec = lvec.detach()
            factor = _clip_factor(_ghost_sq_norms(records), clip, mask)
            acc.flat.zero_()
            for p, g in _ghost_weighted_grads(records, factor):
                slot[id(p)].add_(g)
            del records, dys
            grads = acc.noise_and_average(gen, sigma, mask)
        optimizer.update(grads, lr)
        return (lvec * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return step


def select_train_step(model: nn.Module, optimizer, args, mean, std,
                      class_weights: Optional[np.ndarray] = None, device="cuda") -> Callable:
    """The train step the config asks for (``primia_tpu/train/dp.py:
    select_train_step``): the plain step, or DP-SGD when
    ``differentially_private``: the microbatched path for
    ``augment_multiplicity > 1`` (the mean over views needs per-example
    gradients), else the ghost-norm path unless ``PRIMIA_DP_GHOST=0``.
    One selection point for the local loop and the federated nodes."""
    if not args.differentially_private:
        return build_train_step(model, optimizer, args, mean, std, class_weights, device)
    if (getattr(args, "augment_multiplicity", 1) > 1
            or os.environ.get("PRIMIA_DP_GHOST", "1") == "0"):
        return build_dp_train_step(model, optimizer, args, mean, std, class_weights, device)
    return build_ghost_dp_train_step(model, optimizer, args, mean, std, class_weights, device)


# ----------------------------------------------------------- parameter EMA

class ParameterEMA:
    """The exponential moving average of a model's parameters (De et al.
    2022), evaluated and saved in place of the raw trajectory: DP noise is
    zero-mean, and averaging is post-processing, free of privacy cost.
    ``model`` is a second module that holds the averages and shares the raw
    model's buffers. ``update()`` after a step computes
    ``decay * ema + (1 - decay) * raw``, the JAX loop's formula; an average
    made with ``started=False`` takes the raw parameters at its first
    ``update()`` (the federated loop starts it at the first aggregation)."""

    def __init__(self, raw: nn.Module, decay: float, started: bool = True):
        self.decay, self.started = float(decay), started
        self.model = copy.deepcopy(raw)
        for a, b in zip(self.model.modules(), raw.modules()):
            a._buffers.update(b._buffers)
        self._raw = list(raw.parameters())
        self._avg = list(self.model.parameters())

    @torch.no_grad()
    def update(self) -> None:
        if not self.started:
            torch._foreach_copy_(self._avg, self._raw)
            self.started = True
            return
        torch._foreach_mul_(self._avg, self.decay)
        torch._foreach_add_(self._avg, torch._foreach_mul(self._raw, 1.0 - self.decay))


def parameter_ema(args, model: nn.Module, started: bool = True) -> Optional[ParameterEMA]:
    """The :class:`ParameterEMA` the config asks for: under
    ``differentially_private`` with ``0 < parameter_ema < 1``, else None."""
    decay = float(getattr(args, "parameter_ema", 0.0) or 0.0)
    if args.differentially_private and 0.0 < decay < 1.0:
        return ParameterEMA(model, decay, started)
    return None


# ------------------------------------------------------------- accounting

def _log_comb(n: int, k: int) -> float:
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def rdp_sampled_gaussian(q: float, sigma: float, alpha: int) -> float:
    """RDP of the subsampled Gaussian mechanism at integer order ``alpha``
    (Mironov, Talwar and Zhang 2019, the integer-order sum)."""
    if q == 0:
        return 0.0
    if q == 1.0:
        return alpha / (2 * sigma ** 2)
    logs = [_log_comb(alpha, k) + k * math.log(q) + (alpha - k) * math.log(1 - q)
            + (k * k - k) / (2 * sigma ** 2) for k in range(alpha + 1)]
    m = max(logs)
    return (m + math.log(sum(math.exp(v - m) for v in logs))) / (alpha - 1)


def rdp_epsilon(*, noise_multiplier: float, sample_rate: float, steps: int,
                delta: float = 1e-5, alphas: Sequence[int] = DEFAULT_ALPHAS):
    """``(epsilon, best_alpha)`` after ``steps`` subsampled-Gaussian steps;
    ``(inf, None)`` without noise."""
    if noise_multiplier <= 0:
        return float("inf"), None
    best = (float("inf"), None)
    for a in alphas:
        if a < 2:
            continue
        eps = steps * rdp_sampled_gaussian(sample_rate, noise_multiplier, a) \
            + math.log(1 / delta) / (a - 1)
        if eps < best[0]:
            best = (eps, a)
    return best
