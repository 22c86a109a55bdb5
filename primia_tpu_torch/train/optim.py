"""Adam and SGD with the JAX package's order of operations and a runtime
learning rate.

Port of ``primia_tpu/train/optim.py`` (reference ``train.py:280-303``,
``torch.optim.Adam``/``SGD``), with its semantics:

- weight decay is an L2 term added to the gradient *before* the moment
  or momentum statistics (both optimizers);
- Adam is bias-corrected: ``p -= lr * (m / bc1) / (sqrt(v / bc2) + eps)``
  with ``bc = 1 - beta**t`` in float32;
- SGD momentum has dampening 0 and no Nesterov (the first step's buffer
  is the gradient);
- the learning rate is an argument of every update, so the schedule
  changes it per epoch.

The update runs on the device as multi-tensor ``torch._foreach_*`` ops
over the parameter list, in place. The state maps to and from the
checkpoint's ``AdamState(step, mu, nu)`` / ``SGDState(step, momentum)``:
the JAX package stores the moments of an all-float32 model as one flat
vector in ``ravel_pytree`` order of its parameter tree
(``nn/jax_params.py:param_leaves``), and so does the port.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn as nn

from primia_tpu_torch.nn.jax_params import flatten_jax, from_jax_tree, param_leaves, unflatten_jax
from primia_tpu_torch.train.checkpoint import AdamState, SGDState


class _Optimizer:
    def __init__(self, model: nn.Module, weight_decay: float = 0.0):
        self.leaves = param_leaves(model)
        named = dict(model.named_parameters())
        self.names = [n for n, _ in self.leaves]
        self.params: List[torch.Tensor] = [named[n] for n in self.names]
        self.weight_decay = weight_decay
        self.step = 0

    def _decayed(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        grads = list(grads)
        if self.weight_decay:
            grads = torch._foreach_add(grads, self.params, alpha=self.weight_decay)
        return grads

    def _flat(self, tensors: Sequence[torch.Tensor], on_device: bool = False):
        """One flat vector of ``tensors``: a numpy copy on the host, or with
        ``on_device`` a new tensor on their device."""
        with torch.no_grad():
            flat = flatten_jax(dict(zip(self.names, tensors)), self.leaves).float()
        return flat if on_device else flat.cpu().numpy()

    @torch.no_grad()
    def reset(self) -> None:
        """Back to the state a new optimizer starts from (step 0, zero
        moments), in place: the JAX package's ``optimizer.init(params)``,
        which federated training calls after every aggregation."""
        self.step = 0
        for t in self._moments():
            t.zero_()

    def _load(self, stored, into: Sequence[torch.Tensor]) -> None:
        """Copies a stored moment (flat vector or per-leaf tree) into ``into``."""
        like = dict(zip(self.names, into))
        if isinstance(stored, dict):
            tree = from_jax_tree(stored, {})
        else:
            tree = unflatten_jax(stored, self.leaves, like)
        with torch.no_grad():
            for n, t in like.items():
                t.copy_(tree[n])


class Adam(_Optimizer):
    """``update(grads, lr)``: one Adam step, grads in ``params`` order."""

    def __init__(self, model: nn.Module, beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(model, weight_decay)
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        with torch.no_grad():
            self.mu = [torch.zeros_like(p) for p in self.params]
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.step += 1
        g = self._decayed(grads)
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, g, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1.0 - b2)
        t = np.float32(self.step)
        bc1 = float(np.float32(1.0) - np.float32(b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(b2) ** t)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(self.mu, bc1)
        torch._foreach_mul_(upd, lr)
        torch._foreach_div_(upd, denom)
        torch._foreach_sub_(self.params, upd)

    def _moments(self) -> List[torch.Tensor]:
        return self.mu + self.nu

    def state_to_jax(self, on_device: bool = False) -> AdamState:
        """The checkpoint's state; with ``on_device`` the moments are a
        copy on the card, for a background writer to fetch."""
        return AdamState(np.int32(self.step), self._flat(self.mu, on_device),
                         self._flat(self.nu, on_device))

    def load_jax_state(self, state) -> None:
        self.step = int(np.asarray(state.step))
        self._load(state.mu, self.mu)
        self._load(state.nu, self.nu)


class SGD(_Optimizer):
    """``update(grads, lr)``: one SGD step (momentum without dampening)."""

    def __init__(self, model: nn.Module, momentum: float = 0.0, weight_decay: float = 0.0):
        super().__init__(model, weight_decay)
        self.momentum = momentum
        with torch.no_grad():
            self.buf = [torch.zeros_like(p) for p in self.params] if momentum else None

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.step += 1
        d = self._decayed(grads)
        if self.momentum:
            torch._foreach_mul_(self.buf, self.momentum)
            torch._foreach_add_(self.buf, d)
            d = self.buf
        torch._foreach_sub_(self.params, torch._foreach_mul(d, lr))

    def _moments(self) -> List[torch.Tensor]:
        return self.buf or []

    def state_to_jax(self, on_device: bool = False) -> SGDState:
        return SGDState(np.int32(self.step),
                        self._flat(self.buf, on_device) if self.momentum else None)

    def load_jax_state(self, state) -> None:
        self.step = int(np.asarray(state.step))
        if self.momentum:
            if state.momentum is None:
                raise ValueError("checkpoint has no SGD momentum for a momentum optimizer")
            self._load(state.momentum, self.buf)


def make_optimizer(args, model: nn.Module) -> _Optimizer:
    """Optimizer over ``model``'s parameters from an ``Arguments``
    (reference ``train.py:280-303``)."""
    if args.optimizer == "Adam":
        return Adam(model, args.beta1, args.beta2, weight_decay=args.weight_decay)
    if args.optimizer == "SGD":
        return SGD(model, momentum=args.momentum, weight_decay=args.weight_decay)
    raise ValueError(f"optimizer {args.optimizer!r} not supported")

