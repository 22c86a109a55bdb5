"""Plain forward passes of the benchmark's configurations, from a dict of
weights by name: the layers that every family shares, and the dispatch
to the family's file (``benchmark/reference/families/<family>.py``) and
to the normalisation's (``benchmark/reference/norms/<norm>.py``), each
found by the name that the configuration's ``architecture`` gives.

``precision`` says how the convolutions and linear layers compute:

- ``float32``: operands and results in float32 (the reference);
- ``bfloat16``: operands and results rounded to bfloat16, products
  accumulated in float32, gradients rounded alike (the tensor cores'
  mixed precision);
- ``float8``: operands scaled per tensor into float8 e4m3, gradients into
  e5m2, results rounded to bfloat16 (the next precision down from
  bfloat16).

The reference itself always runs ``float32``; the lower precisions make
the controls that a comparison has to reject.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

_E4M3_MAX, _E5M2_MAX = 448.0, 57344.0


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _quant(t: torch.Tensor, kind: str, grad: bool = False) -> torch.Tensor:
    if kind == "bfloat16":
        return _bf16(t)
    dtype, top = (torch.float8_e5m2, _E5M2_MAX) if grad else (torch.float8_e4m3fn, _E4M3_MAX)
    s = t.detach().abs().amax().clamp(min=1e-30) / top
    return (t / s).to(dtype).float() * s


class _LowConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, kind):
        xq, wq = _quant(x, kind), _quant(w, kind)
        ctx.save_for_backward(xq, wq)
        ctx.conf = (stride, padding, kind)
        return _bf16(F.conv2d(xq, wq, stride=stride, padding=padding))

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        stride, padding, kind = ctx.conf
        gq = _quant(g, kind, grad=True)
        gx = torch.nn.grad.conv2d_input(xq.shape, wq, gq, stride, padding)
        gw = torch.nn.grad.conv2d_weight(xq, wq.shape, gq, stride, padding)
        return _bf16(gx), gw, None, None, None


class _LowLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, kind):
        xq, wq = _quant(x, kind), _quant(w, kind)
        ctx.save_for_backward(xq, wq)
        ctx.kind = kind
        return _bf16(xq @ wq.t())

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _quant(g, ctx.kind, grad=True)
        return _bf16(gq @ wq), gq.t() @ xq, None


def conv(x, w, stride, padding, precision):
    if precision == "float32":
        return F.conv2d(x, w, stride=stride, padding=padding)
    return _LowConv.apply(x, w, stride, padding, precision)


def linear(x, w, b, precision):
    y = x @ w.t() if precision == "float32" else _LowLinear.apply(x, w, precision)
    return y + b


def norm(arch, x, W, B, name, train, settle=False):
    """The configuration's normalisation layer (``architecture.norm``,
    ``benchmark/reference/norms/<norm>.py``) on ``x``."""
    mod = importlib.import_module(f"benchmark.reference.norms.{arch['norm']}")
    return mod.apply(x, W, B, name, train, settle)


def pool(x, kind, window, stride, padding=0):
    if kind == "max":
        return F.max_pool2d(x, window, stride, padding)
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def family(arch: dict):
    """The module of the configuration's family
    (``benchmark/reference/families/<family>.py``)."""
    return importlib.import_module(f"benchmark.reference.families.{arch['family']}")


def forward(W, B, x, arch, train, precision="float32", taps=None, settle=False):
    """The logits of ``x``. ``taps`` (a dict) receives the output layer's
    input as ``head_input``; ``settle`` (train mode) sets each batch norm's
    running statistics in ``B`` to its batch's."""
    # float32 is float32: no TF32 in cuDNN convolutions or matrix products
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return family(arch).forward(W, B, x, arch, train, precision,
                                {} if taps is None else taps, settle)


@torch.no_grad()
def settle_batch_norm(W, B, x, arch) -> None:
    """Sets each batch norm's running statistics (in ``B``, in place) to its
    input's batch statistics on ``x``, as a trained model's match its data;
    a model without batch norm is left as it is."""
    forward(W, B, x, arch, train=True, settle=True)
