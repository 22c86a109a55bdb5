"""Model zoo of the port: ResNet-18, VGG-16, SimpleConv at 28/224/512 px,
and Swin-B (``swin-b``, ``nn/swin.py``) and MaxViT-B (``maxvit-b``,
``nn/maxvit.py``), which the JAX package does not have.

``create_model(args, num_classes, device)`` follows
``primia_tpu/nn/__init__.py:create_model``: the model family, pooling and
normalisation from the config, ``in_channels = 1 if data_dir == "mnist"
or not pretrained else 3``, ResNet-18 and VGG-16 with the fixed
``input_size // 32`` head at ``inference_resolution``, SimpleConv at
``train_resolution``, Swin-B with the window and MaxViT-B with the
partition ``inference_resolution // 32`` and their own norms;
``normalization = group`` for ResNet-18 and SimpleConv only.
``pooling_type`` applies to the CNN stems only: Swin-B's and MaxViT-B's
heads take their mean over tokens (``pooling`` ``"avg"``). The model comes back
in eval mode on ``device``, in ``channels_last`` memory format, with a
seeded-or-not init, or, under
``pretrained = yes``, the local ImageNet weights (``nn/torch_import.py``:
``$PRIMIA_PRETRAINED`` or ``model_weights/<model>-imagenet.pt``; ResNet-18
only) over it; with no such file, or for another family, it warns and
keeps the init, as the JAX package does. The JAX package's
``create_model`` puts the weights into its ``init``, which the train loop
calls; here the model it returns is that init, so the train loop starts
from them, and a checkpoint (``nn/jax_params.py``) replaces them where one
is loaded. Every model exposes ``in_channels``, ``num_classes``,
``input_size`` and ``pooling``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from primia_tpu_torch.nn.maxvit import MaxViT, maxvit_b  # noqa: F401
from primia_tpu_torch.nn.resnet import ResNet, resnet18  # noqa: F401
from primia_tpu_torch.nn.simpleconv import SimpleConv, simpleconv  # noqa: F401
from primia_tpu_torch.nn.swin import SwinTransformer, swin_b  # noqa: F401
from primia_tpu_torch.nn.torch_import import try_load_pretrained
from primia_tpu_torch.nn.vgg import VGG, vgg16  # noqa: F401


def create_model(args, num_classes: int = None, device="cuda") -> nn.Module:
    num_classes = num_classes or args.num_classes
    in_channels = 1 if (args.data_dir == "mnist" or not args.pretrained) else 3
    # getattr: checkpoints from before the field existed have no normalization
    norm = getattr(args, "normalization", "batch")
    if norm != "batch" and args.model not in ("resnet-18", "simpleconv"):
        raise ValueError("normalization=group is only wired for resnet-18/simpleconv")
    if args.model == "resnet-18":
        model = resnet18(num_classes=num_classes, in_channels=in_channels,
                         pooling=args.pooling_type, input_size=args.inference_resolution,
                         norm=norm, zero_init_fc=(norm == "group"))
    elif args.model == "vgg16":
        model = vgg16(num_classes=num_classes, in_channels=in_channels,
                      pooling=args.pooling_type, input_size=args.inference_resolution)
    elif args.model == "simpleconv":
        model = simpleconv(resolution=args.train_resolution, num_classes=num_classes,
                           in_channels=in_channels, pooling=args.pooling_type, norm=norm,
                           zero_init_fc=(norm == "group"))
    elif args.model == "swin-b":
        model = swin_b(num_classes=num_classes, in_channels=in_channels,
                       input_size=args.inference_resolution)
    elif args.model == "maxvit-b":
        model = maxvit_b(num_classes=num_classes, in_channels=in_channels,
                         input_size=args.inference_resolution)
    else:
        raise ValueError(f"unknown model {args.model!r}")
    if args.pretrained:
        init = try_load_pretrained(args.model, args)
        if init is not None:
            model = init(model)
    return model.to(device=torch.device(device),
                    memory_format=torch.channels_last).eval()
