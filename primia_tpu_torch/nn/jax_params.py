"""Carry weights between the JAX package's parameter trees and the port's
modules.

The JAX package keeps a model as two nested trees of numpy-convertible
arrays, ``params`` and ``state`` (batch-norm running statistics), with
NHWC layouts: conv weights HWIO, linear weights (in, out). The port's
modules use PyTorch's layouts: conv OIHW, linear (out, in). Names map
one to one: ``params["layer1"][0]["conv1"]["w"]`` is
``layer1.0.conv1.weight``.

Leaves: ``w`` of a conv -> ``weight`` (HWIO -> OIHW), and ``b`` ->
``bias`` where the conv has one (VGG-16, SimpleConv); ``w``/``b`` of a
linear -> ``weight`` (transposed)/``bias``; ``gamma``/``beta`` of a norm
-> ``weight``/``bias``; its state ``mean``/``var``/``count`` ->
``running_mean``/``running_var``/``num_batches_tracked`` (int64).

A numbered level of module names is a JAX list when its keys are
``0 .. n-1`` (a layer's blocks, VGG's ``features``, the classifiers) and
a dict with string keys otherwise (SimpleConv's ``bns``: ``"0"``, ``"1"``,
``"3"``), as in the JAX trees.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from primia_tpu_torch.nn.core import Conv, Norm

_PARAM_LEAF = {"gamma": "weight", "beta": "bias", "b": "bias"}
_STATE_LEAF = {"mean": "running_mean", "var": "running_var",
               "count": "num_batches_tracked"}


def _to_torch_layout(leaf: str, a: np.ndarray) -> np.ndarray:
    if leaf == "w" and a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    if leaf == "w" and a.ndim == 2:
        return a.T
    return a


def _walk(tree, prefix: str, leaf_names: Dict[str, str], out: Dict[str, torch.Tensor]):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        raise TypeError(f"unexpected node {type(tree).__name__} at {prefix!r}")
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            _walk(v, f"{prefix}{k}.", leaf_names, out)
            continue
        if k not in leaf_names:
            raise KeyError(f"unknown leaf {prefix}{k}")
        a = _to_torch_layout(k, np.asarray(v))
        out[prefix + leaf_names[k]] = torch.from_numpy(np.array(a, order="C"))


def from_jax_tree(params: Dict[str, Any], state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ``(params, state)`` trees -> a state dict for the port's model."""
    out: Dict[str, torch.Tensor] = {}
    _walk(params, "", {"w": "weight", **_PARAM_LEAF}, out)
    _walk(state, "", _STATE_LEAF, out)
    return out


def _nest(flat: Dict[str, Dict[str, np.ndarray]]) -> Dict[str, Any]:
    """``{"layer1.0.bn1": leaves}`` -> nested dicts, with the numbered
    levels (a layer's blocks) as lists."""
    root: Dict[str, Any] = {}
    for path, leaves in flat.items():
        *parents, last = path.split(".")
        node = root
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = leaves
    return _listify(root)


def _listify(node):
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and set(out) == {str(i) for i in range(len(out))}:
        return [out[str(i)] for i in range(len(out))]
    return out


def _module_params(m: nn.Module) -> Dict[str, Tuple[str, str]]:
    """``{JAX leaf: (attribute, layout)}`` of one module's parameters;
    empty for a module that holds none of its own. Layout ``"conv"``
    (OIHW here, HWIO there), ``"linear"`` ((out, in) here, (in, out)
    there) or ``"vector"``."""
    if isinstance(m, Conv):
        return {"w": ("weight", "conv"),
                **({} if m.bias is None else {"b": ("bias", "vector")})}
    if isinstance(m, nn.Linear):
        return {"w": ("weight", "linear"), "b": ("bias", "vector")}
    if isinstance(m, Norm):
        return {"gamma": ("weight", "vector"), "beta": ("bias", "vector")}
    return {}


def _np(t: torch.Tensor) -> np.ndarray:
    """A copy: a CPU tensor's ``numpy()`` shares its memory, and the
    trees must not change when the model trains on."""
    return t.detach().cpu().numpy().copy()


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order: dict keys sorted, lists in order."""
    for _, leaf in _paths(tree, ()):
        yield leaf


def param_leaves(module: nn.Module) -> List[Tuple[str, str]]:
    """``(parameter name, layout)`` for every leaf of the module's JAX
    ``params`` tree, in ``jax.tree.leaves`` order, which is the order of
    ``ravel_pytree``: the JAX optimizers store their moments as one flat
    vector in it. Layout ``"conv"`` (OIHW here, HWIO there), ``"linear"``
    ((out, in) here, (in, out) there) or ``"vector"``."""
    flat: Dict[str, Dict[str, Tuple[str, str]]] = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        leaves = _module_params(m)
        if leaves:
            flat[name] = {k: (pre + a, lay) for k, (a, lay) in leaves.items()}
    return list(_leaves(_nest(flat)))


def _jax_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    if layout == "conv":
        return t.permute(2, 3, 1, 0)
    if layout == "linear":
        return t.t()
    return t


def flatten_jax(tensors: Dict[str, torch.Tensor], leaves: List[Tuple[str, str]]) -> torch.Tensor:
    """One flat vector of ``tensors`` (named like the module's parameters)
    in the JAX layout and ``ravel_pytree`` order of ``leaves``."""
    return torch.cat([_jax_layout(tensors[n], lay).reshape(-1) for n, lay in leaves])


def unflatten_jax(flat, leaves: List[Tuple[str, str]],
                  like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`flatten_jax`: a flat vector in the JAX layout ->
    tensors shaped, typed and placed like ``like``."""
    flat = torch.as_tensor(np.asarray(flat)).reshape(-1)
    out, off = {}, 0
    for n, lay in leaves:
        ref = like[n]
        jshape = tuple(_jax_layout(torch.empty(ref.shape, device="meta"), lay).shape)
        k = ref.numel()
        a = flat[off:off + k].reshape(jshape)
        if lay == "conv":
            a = a.permute(3, 2, 0, 1)
        elif lay == "linear":
            a = a.t()
        out[n] = a.to(device=ref.device, dtype=ref.dtype).contiguous()
        off += k
    if off != flat.numel():
        raise ValueError(f"flat vector of {flat.numel()} values for {off} parameters")
    return out


def to_jax_tree(module: nn.Module) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The port's model -> JAX ``(params, state)`` trees that the JAX
    package's ``forward`` and checkpoint loader read."""
    params: Dict[str, Dict[str, np.ndarray]] = {}
    state: Dict[str, Dict[str, np.ndarray]] = {}
    for name, m in module.named_modules():
        leaves = _module_params(m)
        if leaves:
            params[name] = {k: np.ascontiguousarray(_np(_jax_layout(getattr(m, a), lay)))
                            for k, (a, lay) in leaves.items()}
        if isinstance(m, Norm):
            state[name] = {k: _np(getattr(m, a)) for k, a in _STATE_LEAF.items()}
    return _nest(params), _nest(state)


def jax_leaf_paths(module: nn.Module) -> List[Tuple[tuple, str]]:
    """``(path, tensor name)`` for every leaf of :func:`to_jax_tree`'s trees
    joined as ``{"params": params, "state": state}``, in ``jax.tree.leaves``
    order. The path holds the keys JAX's tree utilities give it (dict keys,
    then list indices), the name is the leaf's key in
    ``module.state_dict()``: ``(("params", "layer1", 0, "conv1", "w"),
    "layer1.0.conv1.weight")``."""
    params: Dict[str, Dict[str, str]] = {}
    state: Dict[str, Dict[str, str]] = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        leaves = _module_params(m)
        if leaves:
            params[name] = {k: pre + a for k, (a, _) in leaves.items()}
        if isinstance(m, Norm):
            state[name] = {k: pre + v for k, v in _STATE_LEAF.items()}
    return list(_paths({"params": _nest(params), "state": _nest(state)}, ()))


def _paths(tree, prefix: tuple):
    """``(path, leaf)`` in ``jax.tree.leaves`` order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree
