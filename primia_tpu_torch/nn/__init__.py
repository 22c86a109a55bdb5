"""Model zoo of the port: ResNet-18 so far.

``create_model(args, num_classes, device)`` follows
``primia_tpu/nn/__init__.py:create_model``: the model family, pooling and
normalisation from the config, ``in_channels = 1 if data_dir == "mnist"
or not pretrained else 3``, and the fixed ``input_size // 32`` head at
``inference_resolution``. The model comes back in eval mode on
``device``, in ``channels_last`` memory format, with a seeded-or-not He
init, or, under ``pretrained = yes``, the local ImageNet weights
(``nn/torch_import.py``: ``$PRIMIA_PRETRAINED`` or
``model_weights/<model>-imagenet.pt``) over it; with no such file it warns
and keeps the He init, as the JAX package does. The JAX package's
``create_model`` puts the weights into its ``init``, which the train loop
calls; here the model it returns is that init, so the train loop starts
from them, and a checkpoint (``nn/jax_params.py``) replaces them where one
is loaded.
"""

from __future__ import annotations

import torch

from primia_tpu_torch.nn.resnet import ResNet, resnet18  # noqa: F401
from primia_tpu_torch.nn.torch_import import try_load_pretrained

_NOT_PORTED = {
    "vgg16": "nn/vgg.py (ROADMAP queue 1, slice 2, item 1: models)",
    "simpleconv": "nn/simpleconv.py (ROADMAP queue 1, slice 2, item 1: models)",
}


def create_model(args, num_classes: int = None, device="cuda") -> ResNet:
    num_classes = num_classes or args.num_classes
    if args.model in _NOT_PORTED:
        raise NotImplementedError(
            f"model {args.model!r} is not ported yet: {_NOT_PORTED[args.model]}")
    if args.model != "resnet-18":
        raise ValueError(f"unknown model {args.model!r}")
    in_channels = 1 if (args.data_dir == "mnist" or not args.pretrained) else 3
    norm = getattr(args, "normalization", "batch")
    model = resnet18(num_classes=num_classes, in_channels=in_channels,
                     pooling=args.pooling_type, input_size=args.inference_resolution,
                     norm=norm, zero_init_fc=(norm == "group"))
    if args.pretrained:
        init = try_load_pretrained(args.model, args)
        if init is not None:
            model = init(model)
    return model.to(device=torch.device(device),
                    memory_format=torch.channels_last).eval()
