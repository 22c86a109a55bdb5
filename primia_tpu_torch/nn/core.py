"""Plain NN ops on NCHW tensors, and the modules that hold their weights.

Port of the plain engine of ``primia_tpu/nn/core.py``. The JAX package
is NHWC with HWIO conv weights and (in, out) linear weights; here
activations are NCHW (``channels_last`` in memory on the card), conv
weights OIHW and linear weights (out, in) — ``nn/jax_params.py`` maps one
layout onto the other. Convolutions go to ``F.conv2d`` (cuDNN on the
card), as the JAX package left them to XLA.

Batch norm runs in eval mode from its running statistics and in train
mode from the batch's, with torch's running-statistics semantics; group
norm has no running statistics.

The JAX package's two opt-in kernel switches of this module are read here
by the same names, so one setting picks the same path in both packages:

- ``PRIMIA_PALLAS_WGRAD=1``: a 3x3, stride-1, pad-1 conv of a batch of
  more than one with at least 128 channels in and out, computed in
  bfloat16, is ``ops/cuda_wgrad.py:conv3x3_s1p1``, whose weight gradient
  is K7 (``primia_tpu/nn/core.py:PlainEngine.conv2d``).
- ``PRIMIA_PALLAS_BN=1``: train-mode batch norm of a 4-D bfloat16
  activation is ``ops/cuda_bn.py:bn_train``, its sums K8 and the
  finalize and elementwise passes around them
  (``primia_tpu/nn/core.py:batch_norm``).

The JAX package honours them only on a TPU. The port honours them on
every device: on CUDA a switch that is set launches the kernel or raises,
on the CPU the same dispatch runs the kernels' plain versions.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from primia_tpu_torch.ops.cuda_bn import bn_train, use_pallas_bn
from primia_tpu_torch.ops.cuda_swin_norm import add_norm
from primia_tpu_torch.ops.cuda_wgrad import conv3x3_s1p1, use_pallas_wgrad


def _channel(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(1, -1, 1, 1)


def bn_fold(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float = 1e-5) -> Dict[str, torch.Tensor]:
    """Inference batch norm as a channelwise affine ``x * scale + offset``,
    with the channel math in float32 (``primia_tpu/nn/core.py:bn_fold`` and
    the eval branch of ``batch_norm``)."""
    inv = gamma.float() * torch.rsqrt(var.float() + eps)
    return {"scale": inv, "offset": beta.float() - mean.float() * inv}


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Eval-mode batch norm from running statistics: the float32 affine of
    :func:`bn_fold`, cast to the activation dtype."""
    f = bn_fold(gamma, beta, mean, var, eps)
    return x * _channel(f["scale"]).to(x.dtype) + _channel(f["offset"]).to(x.dtype)


def group_normalize(x: torch.Tensor, groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm's normalisation, without the affine: per-example
    statistics over (C/G, H, W) of each of ``min(groups, C)`` groups of
    neighbouring channels, in float32; ``x_hat`` in ``x``'s dtype."""
    B, C = x.shape[:2]
    G = min(groups, C)
    if C % G:
        raise ValueError(f"channels {C} not divisible by groups {G}")
    xf = x.float().reshape(B, G, -1)
    mean = xf.mean(-1, keepdim=True)
    var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp(min=0.0)
    return ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)


def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               groups: int = 32, eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm with ``torch.nn.GroupNorm`` semantics: :func:`group_normalize`,
    then the channelwise affine ``x_hat * gamma + beta``. The two halves
    are apart because the ghost-norm DP step (``train/dp.py``) records the
    affine's input ``x_hat``, as the JAX package's ``E.affine`` does."""
    return group_normalize(x, groups, eps) * _channel(gamma) + _channel(beta)


def avg_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Average pool dividing by ``window**2`` everywhere
    (``count_include_pad=True``, as the reference model's AvgPool2d)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def pool2x2(x: torch.Tensor, pooling: str) -> torch.Tensor:
    """VGG-16's and SimpleConv's 2x2/s2 pool, max or avg; odd sizes floor."""
    return F.max_pool2d(x, 2, 2) if pooling == "max" else avg_pool(x, 2, 2)


def mlp_head(classifier: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    """VGG-16's and SimpleConv's classifier on the flattened features: its
    linears, a ReLU after each but the last."""
    x = torch.flatten(x, 1)
    for lin in classifier[:-1]:
        x = F.relu(lin(x))
    return classifier[-1](x)


def _compute_dtype(x: torch.Tensor, w: torch.Tensor):
    """The dtype a conv of ``x`` and ``w`` computes in: autocast's where
    autocast is on for ``x``'s device, else the operands' shared dtype
    (None where they differ)."""
    if torch.is_autocast_enabled(x.device.type):
        return torch.get_autocast_dtype(x.device.type)
    return x.dtype if x.dtype == w.dtype else None


class Conv(nn.Module):
    """NCHW conv with OIHW weights and symmetric padding; He-normal
    (fan_out, relu gain) init as the JAX package's ``kaiming_normal_conv``.
    With ``bias=True`` (VGG-16's and SimpleConv's convs; ResNet's have
    none) a zero-initialised bias is added after the conv in the conv's
    output dtype, as the JAX package's ``E.bias_add``. Under
    ``PRIMIA_PALLAS_WGRAD=1`` a conv that meets the JAX package's
    condition runs as ``conv3x3_s1p1`` on the bfloat16 operands: the same
    forward and data gradient, the weight gradient from K7, cast to
    bfloat16 and back to the float32 parameter as autocast's gradient
    is."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, padding: int = 0,
                 bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        nn.init.normal_(self.weight, std=math.sqrt(2.0 / (k * k * cout)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if (self.stride == 1 and self.padding == 1 and w.shape[2:] == (3, 3)
                and x.dim() == 4 and x.shape[0] > 1
                # C >= 128 only, as the JAX package (nn/core.py:50-56)
                and w.shape[1] >= 128 and w.shape[0] >= 128
                and _compute_dtype(x, w) == torch.bfloat16 and use_pallas_wgrad()):
            with torch.autocast(x.device.type, enabled=False):
                y = conv3x3_s1p1(x.to(torch.bfloat16), w.to(torch.bfloat16))
        else:
            y = F.conv2d(x, w, stride=self.stride, padding=self.padding)
        return y if self.bias is None else y + _channel(self.bias.to(y.dtype))


class Norm(nn.Module):
    """Batch norm (``kind="batch"``), group norm (``kind="group"``) or layer
    norm (``kind="layer"``). Batch and group norm keep the same weights and
    BN-shaped buffers, so checkpoints are layout-identical, as in the JAX
    package. Layer norm (the Swin Transformer's, ``nn/swin.py``) normalises
    the last dimension in float32 and has no running-statistics buffers:
    ``ops/cuda_swin_norm.py:add_norm`` (``F.layer_norm`` on the CPU, one
    kernel launch a direction on the card), whose keywords ``forward``
    passes on (a residual branch to add first, the row orders of the branch
    and of the output, the output's dtype: float32 unless given); it
    returns the residual stream after the add and the normalised rows.

    Train-mode batch norm follows ``primia_tpu/nn/core.py:batch_norm``
    (train=True): float32 batch statistics over (N, H, W), the biased
    variance to normalise, the *unbiased* one into ``running_var``,
    ``new = (1 - 0.1) * old + 0.1 * batch`` and ``num_batches_tracked += 1``.
    It is ``F.batch_norm``, which computes exactly that (the JAX package
    left BN to XLA); a bfloat16 input keeps float32 statistics and
    parameters. Under ``PRIMIA_PALLAS_BN=1`` a 4-D bfloat16 input takes
    ``bn_train`` instead (three kernel launches a direction on the card:
    K8's sums, a finalize that also updates the running statistics, and
    one elementwise pass; float32 parameters), with the same
    running-statistics update."""

    momentum = 0.1
    groups = 32  # group norm's groups (min(groups, C)), as the JAX package's default
    # data parallelism over ranks (parallel/data_parallel.py): the ranks
    # that share the batch, whose statistics train-mode batch norm takes
    ranks = None

    def __init__(self, c: int, kind: str = "batch", eps: float = 1e-5):
        super().__init__()
        if kind not in ("batch", "group", "layer"):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.eps = kind, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        if kind == "layer":
            return
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.int64))

    def forward(self, x: torch.Tensor, **fused):
        """The normalised x, or for a layer norm the pair (residual stream,
        normalised rows) of :func:`add_norm`."""
        if self.kind == "layer":
            fused.setdefault("out_dtype", torch.float32)
            return add_norm(x, self.weight, self.bias, self.eps, **fused)
        if self.kind == "group":
            return group_norm(x, self.weight, self.bias, self.groups, self.eps)
        if self.training:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
            if x.dim() == 4 and x.dtype == torch.bfloat16 and use_pallas_bn():
                return self._bn_train(x)
            if self.ranks is not None:
                return _SyncBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                            self.running_var, self.eps, self.momentum,
                                            self.ranks)
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                                self.bias, training=True, momentum=self.momentum,
                                eps=self.eps)
        return batch_norm(x, self.weight, self.bias, self.running_mean,
                          self.running_var, self.eps)

    def _bn_train(self, x: torch.Tensor) -> torch.Tensor:
        """``bn_train`` with the running statistics, which its finalize
        updates as ``primia_tpu/nn/core.py:batch_norm`` (train=True) does:
        the unbiased variance, ``(1 - m) * old + m * batch``."""
        with torch.autocast(x.device.type, enabled=False):
            y, _, _ = bn_train(x, self.weight, self.bias, self.eps, self.running_mean,
                               self.running_var, self.momentum, ranks=self.ranks)
        return y


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the batch that ``ranks`` share, each
    holding an equal number of its rows: the statistics of the whole
    batch, as the JAX step's (XLA partitions its reductions).

    Forward: each rank's per-channel mean and centred sum of squares
    (float32) are gathered (``ranks.gather``) and merged (Chan's
    pairwise update: mean of the means, M2 = sum M2_r + n sum (mean_r -
    mean)^2); y = (x - mean) rsqrt(var + eps) gamma + beta in x's dtype;
    the running statistics move as ``F.batch_norm`` moves them, with the
    whole batch's unbiased variance. Backward: the per-channel sums of g
    and g xhat are summed over the ranks (``ranks.sum_``) for dx; gamma's
    and beta's gradients stay this rank's own sums, which the step's
    gradient reduction adds up."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, ranks):
        xf = x.float()
        dims = [0] + list(range(2, x.dim()))
        n = x.numel() // x.shape[1]
        mean_r = xf.mean(dims)
        m2_r = (xf - _channel(mean_r)).square().sum(dims)
        g = ranks.gather(torch.stack([mean_r, m2_r]))  # (ranks, 2, C)
        mean = g[:, 0].mean(0)
        m2 = g[:, 1].sum(0) + n * (g[:, 0] - mean).square().sum(0)
        N = n * ranks.size
        var = m2 / N
        invstd = torch.rsqrt(var + eps)
        xhat = (xf - _channel(mean)) * _channel(invstd)
        y = (xhat * _channel(weight.float()) + _channel(bias.float())).to(x.dtype)
        with torch.no_grad():
            running_mean.mul_(1 - momentum).add_(mean, alpha=momentum)
            running_var.mul_(1 - momentum).add_(m2 / max(N - 1, 1), alpha=momentum)
        ctx.save_for_backward(xhat, weight, invstd)
        ctx.ranks, ctx.N = ranks, N
        return y

    @staticmethod
    def backward(ctx, gy):
        xhat, weight, invstd = ctx.saved_tensors
        gf = gy.float()
        dims = [0] + list(range(2, gf.dim()))
        local = torch.stack([gf.sum(dims), (gf * xhat).sum(dims)])
        total = ctx.ranks.sum_(local.clone())
        dx = _channel(weight.float() * invstd) * (
            gf - _channel(total[0] / ctx.N) - xhat * _channel(total[1] / ctx.N))
        return (dx.to(gy.dtype), local[1].to(weight.dtype), local[0].to(weight.dtype),
                None, None, None, None, None)
