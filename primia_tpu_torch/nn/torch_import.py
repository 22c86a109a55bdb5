"""Import torchvision ResNet-18 state dicts onto the port's modules.

Port of ``primia_tpu/nn/torch_import.py``. The reference downloads
ImageNet weights through ``torch.hub``; with no network, ``pretrained =
yes`` resolves a local file instead, in this order:

1. ``$PRIMIA_PRETRAINED`` (path to a ``.pt``/``.pth`` state dict), else
2. ``model_weights/<model>-imagenet.pt`` relative to the working
   directory, else
3. warn and keep the He initialisation.

The port's modules already use PyTorch's layouts (conv OIHW, linear
(out, in)), so the conversion is a renaming: torchvision's
``layerK.i.downsample.0`` and ``downsample.1`` are the port's
``down_conv`` and ``down_bn`` (the JAX package's names); every other name
is the same.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn as nn

_RENAMES = ((".down_conv.", ".downsample.0."), (".down_bn.", ".downsample.1."))


def _torchvision_name(name: str) -> str:
    """The torchvision state-dict key of the port's key ``name``."""
    for ours, theirs in _RENAMES:
        name = name.replace(ours, theirs)
    return name


def resnet18_from_torch_state_dict(sd: Dict[str, Any],
                                   state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Overlay a torchvision resnet18 state dict ``sd`` onto the port's
    state dict ``state``; returns the new state dict.

    Conv weights, BN affine parameters and running statistics are copied
    (``num_batches_tracked`` is 0 where ``sd`` has none). The final fc is
    copied only when its shape matches: the reference loads the 1000-class
    checkpoint, then swaps in a fresh ``num_classes`` head
    (``primia_tpu/nn/torch_import.py:76-78``).
    """
    out = dict(state)
    for name, t in state.items():
        if name.startswith("fc."):
            continue
        src = _torchvision_name(name)
        if name.endswith("num_batches_tracked"):
            out[name] = torch.as_tensor(sd.get(src, 0), dtype=t.dtype).reshape(t.shape)
        else:
            out[name] = torch.as_tensor(sd[src], dtype=t.dtype)
    fc_w = torch.as_tensor(sd["fc.weight"])
    if fc_w.shape == state["fc.weight"].shape:
        out["fc.weight"] = fc_w.to(state["fc.weight"].dtype)
        out["fc.bias"] = torch.as_tensor(sd["fc.bias"], dtype=state["fc.bias"].dtype)
    return out


def try_load_pretrained(model_name: str, args=None) -> Optional[Callable[[nn.Module], nn.Module]]:
    """For ``pretrained = yes``: a function that overlays the local
    ImageNet weights onto a freshly initialised model (and returns it), or
    None after a warning, as ``primia_tpu/nn/torch_import.py:
    try_load_pretrained`` (no file; a model other than ResNet-18)."""
    candidates = []
    if os.environ.get("PRIMIA_PRETRAINED"):
        candidates.append(os.environ["PRIMIA_PRETRAINED"])
    candidates.append(os.path.join("model_weights", f"{model_name}-imagenet.pt"))
    path = next((c for c in candidates if os.path.isfile(c)), None)
    if path is None:
        warnings.warn(
            f"pretrained=yes but no local weights found for {model_name} "
            "(no network egress; set $PRIMIA_PRETRAINED). Using He init.",
        )
        return None
    if model_name != "resnet-18":
        warnings.warn(f"pretrained import not implemented for {model_name}")
        return None

    def init(model: nn.Module) -> nn.Module:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        model.load_state_dict(resnet18_from_torch_state_dict(sd, model.state_dict()))
        return model

    return init
