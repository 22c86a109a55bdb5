"""Configuration system: INI file + CLI flags merged into one object.

Port of ``primia_tpu/config.py``: the same fields, INI keys, fallbacks
and derived behaviours, so a config or checkpoint translates one-to-one
between the two packages (``tests/test_torch_inference.py`` holds every
``configs/torch/*.ini`` to equal ``to_dict()`` in both).

Mirrors the user-facing contract of the reference config layer
(PriMIA ``torchlib/utils.py:92-302`` ``Arguments``): the same INI sections
(``[config]``, ``[augmentation]``, ``[albumentations]``, ``[federated]``,
``[system]``), the same field names and fallbacks, and the same derived
behaviors (mixup with prob 1.0 doubles the batch size; federated
``repetitions_dataset`` divides the epoch count). The object is JSON
round-trippable so it can be embedded in checkpoints and restored at
inference time (reference: ``inference.py:82-93``).
"""

from __future__ import annotations

import configparser
import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional

VALID_MODELS = ("simpleconv", "resnet-18", "vgg16")
VALID_OPTIMIZERS = ("SGD", "Adam")
VALID_POOLING = ("max", "avg")


@dataclass(kw_only=True)
class Arguments:
    """All knobs for training / inference, merged from INI + CLI.

    Field names follow the reference so that configs and checkpoints
    translate one-to-one.
    """

    # --- bookkeeping
    name: str = "default"
    save_file: str = "model_weights/completed_trainings.csv"
    mode: str = "train"

    # --- [config]
    batch_size: int = 32
    test_batch_size: int = 32
    train_resolution: int = 224
    inference_resolution: int = 224
    validation_split: int = 10  # percent of train data held out
    epochs: int = 1
    lr: float = 1e-3
    end_lr: float = 1e-3
    deterministic: bool = True
    restarts: int = 0
    seed: int = 1
    test_interval: int = 1
    log_interval: int = 10
    optimizer: str = "Adam"
    differentially_private: bool = False
    beta1: float = 0.9
    beta2: float = 0.999
    momentum: float = 0.0
    model: str = "resnet-18"
    pooling_type: str = "max"
    # "batch" (reference) or "group": GroupNorm is the DP-compatible
    # normalization — DP-SGD must freeze BatchNorm at its running stats
    # (cross-example coupling breaks per-sample gradients; opacus
    # rejects BN outright), which for a from-scratch model means NO
    # effective normalization and training collapses. TPU-build
    # extension; the reference has no DP-trainable model at all
    # (torchdp rejects its BN ResNet, train.py:308).
    normalization: str = "batch"
    pretrained: bool = False
    weight_decay: float = 0.0
    weight_classes: bool = False

    # --- [augmentation]
    rotation: float = 0.0
    translate: float = 0.0
    scale: float = 0.0
    shear: float = 0.0
    mixup: bool = False
    mixup_prob: float = 0.0
    mixup_lambda: Optional[float] = None

    # --- [albumentations]
    albu_prob: float = 1.0
    individual_albu_probs: float = 1.0
    noise_std: float = 0.0
    noise_prob: float = 0.0
    clahe: bool = False
    randomgamma: bool = False
    randombrightness: bool = False
    blur: bool = False
    elastic: bool = False
    optical_distortion: bool = False
    grid_distortion: bool = False
    grid_shuffle: bool = False
    hsv: bool = False
    invert: bool = False
    cutout: bool = False
    shadow: bool = False
    fog: bool = False
    sun_flare: bool = False
    solarize: bool = False
    equalize: bool = False
    grid_dropout: bool = False

    # --- [federated]
    train_federated: bool = False
    unencrypted_aggregation: bool = False
    sync_every_n_batch: int = 10
    wait_interval: float = 0.1
    keep_optim_dict: bool = False
    repetitions_dataset: int = 1
    weighted_averaging: bool = False
    precision_fractional: int = 16

    # --- [system]
    num_threads: int = 0
    # compute precision for the training forward/backward: "auto" picks
    # bfloat16 on TPU (MXU-native) and float32 elsewhere; master params,
    # optimizer state and BN statistics always stay float32. TPU-build
    # extension; absent from the reference INIs (torch CPU is fp32-only).
    compute_dtype: str = "auto"

    # --- [dp] (reference hardcodes these at train.py:326-334)
    noise_multiplier: float = 1.3
    max_grad_norm: float = 1.0
    target_delta: float = 1e-5
    # average per-example gradients over K independent augmentations
    # BEFORE clipping (augmentation multiplicity, De et al. 2022):
    # reduces per-example gradient variance at zero privacy cost
    # because the clipped unit is still one example. K=1 disables.
    augment_multiplicity: int = 1
    # exponential moving average of the parameters, evaluated/saved in
    # place of the raw trajectory (De et al. 2022): DP noise is
    # zero-mean, so averaging the trajectory cancels the injected
    # random walk at no privacy cost (post-processing). 0 disables;
    # typical 0.95-0.999.
    parameter_ema: float = 0.0

    # --- CLI-only
    data_dir: str = "data/train"
    visdom: bool = False
    cuda: bool = False  # reference CLI flag, kept for checkpoint parity
    websockets: bool = False
    encrypted_inference: bool = False
    resume_checkpoint: Optional[str] = None

    # --- derived, fixed after __post_init__
    num_classes: int = 3

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        if self.model not in VALID_MODELS:
            raise ValueError(f"Unknown model {self.model!r}; choose from {VALID_MODELS}")
        if self.optimizer not in VALID_OPTIMIZERS:
            raise ValueError(
                f"Unknown optimizer {self.optimizer!r}; choose from {VALID_OPTIMIZERS}"
            )
        if self.pooling_type not in VALID_POOLING:
            raise ValueError(
                f"Unknown pooling {self.pooling_type!r}; choose from {VALID_POOLING}"
            )
        if self.normalization not in ("batch", "group"):
            raise ValueError(
                f"Unknown normalization {self.normalization!r}; "
                "choose from ('batch', 'group')"
            )
        if self.mode not in ("train", "inference"):
            raise ValueError("mode must be 'train' or 'inference'")

    # ------------------------------------------------------------------ INI

    @classmethod
    def from_ini(
        cls,
        config_path: str | Path,
        *,
        mode: str = "train",
        cmd_args: Any = None,
        verbose: bool = False,
    ) -> "Arguments":
        """Build from an INI file plus an (optional) argparse namespace.

        Reference: ``torchlib/utils.py:92-254``.
        """
        cp = configparser.ConfigParser()
        read = cp.read(str(config_path))
        if not read:
            raise FileNotFoundError(f"Configuration file not found: {config_path}")

        g = _IniGetter(cp)
        kw: Dict[str, Any] = {"mode": mode}

        kw["batch_size"] = g.int("config", "batch_size", fallback=32)
        kw["test_batch_size"] = g.int("config", "test_batch_size", fallback=32)
        kw["train_resolution"] = g.int("config", "train_resolution", fallback=224)
        kw["inference_resolution"] = g.int(
            "config", "inference_resolution", fallback=kw["train_resolution"]
        )
        kw["validation_split"] = g.int("config", "validation_split", fallback=10)
        kw["epochs"] = g.int("config", "epochs", fallback=1)
        kw["lr"] = g.float("config", "lr", fallback=1e-3)
        kw["end_lr"] = g.float("config", "end_lr", fallback=kw["lr"])
        kw["deterministic"] = g.bool("config", "deterministic", fallback=True)
        kw["restarts"] = g.int("config", "restarts", fallback=0)
        kw["seed"] = g.int("config", "seed", fallback=1)
        kw["test_interval"] = g.int("config", "test_interval", fallback=1)
        kw["log_interval"] = g.int("config", "log_interval", fallback=10)
        kw["optimizer"] = g.str("config", "optimizer", fallback="Adam")
        kw["differentially_private"] = g.bool(
            "config", "differentially_private", fallback=False
        )
        if kw["optimizer"] == "Adam":
            kw["beta1"] = g.float("config", "beta1", fallback=0.9)
            kw["beta2"] = g.float("config", "beta2", fallback=0.999)
        else:
            kw["momentum"] = g.float("config", "momentum", fallback=0.0)
        kw["model"] = g.str("config", "model", fallback="resnet-18")
        kw["pooling_type"] = g.str("config", "pooling_type", fallback="max")
        kw["normalization"] = g.str("config", "normalization", fallback="batch")
        kw["pretrained"] = g.bool("config", "pretrained", fallback=False)
        kw["weight_decay"] = g.float("config", "weight_decay", fallback=0.0)
        kw["weight_classes"] = g.bool("config", "weight_classes", fallback=False)

        kw["rotation"] = g.float("augmentation", "rotation", fallback=0.0)
        kw["translate"] = g.float("augmentation", "translate", fallback=0.0)
        kw["scale"] = g.float("augmentation", "scale", fallback=0.0)
        kw["shear"] = g.float("augmentation", "shear", fallback=0.0)
        kw["mixup"] = g.bool("augmentation", "mixup", fallback=False)
        kw["mixup_prob"] = g.float("augmentation", "mixup_prob", fallback=0.0)
        kw["mixup_lambda"] = g.float("augmentation", "mixup_lambda", fallback=None)

        kw["albu_prob"] = g.float("albumentations", "overall_prob", fallback=1.0)
        kw["individual_albu_probs"] = g.float("albumentations", "individual_probs", fallback=1.0)
        kw["noise_std"] = g.float("albumentations", "noise_std", fallback=0.0)
        kw["noise_prob"] = g.float("albumentations", "noise_prob", fallback=0.0)
        for flag in (
            "clahe", "randomgamma", "randombrightness", "blur", "elastic",
            "optical_distortion", "grid_distortion", "grid_shuffle", "hsv",
            "invert", "cutout", "shadow", "fog", "sun_flare", "solarize",
            "equalize", "grid_dropout",
        ):
            kw[flag] = g.bool("albumentations", flag, fallback=False)

        # mixup with prob 1.0 doubles batch size (reference utils.py:210-212)
        if kw["mixup"] and kw["mixup_prob"] == 1.0:
            kw["batch_size"] *= 2
            if verbose:
                print("Doubled batch size because of mixup")

        train_federated = bool(getattr(cmd_args, "train_federated", False)) and mode == "train"
        kw["train_federated"] = train_federated
        kw["unencrypted_aggregation"] = (
            bool(getattr(cmd_args, "unencrypted_aggregation", False))
            if mode == "train"
            else False
        )
        if train_federated:
            kw["sync_every_n_batch"] = g.int("federated", "sync_every_n_batch", fallback=10)
            kw["wait_interval"] = g.float("federated", "wait_interval", fallback=0.1)
            kw["keep_optim_dict"] = g.bool("federated", "keep_optim_dict", fallback=False)
            kw["repetitions_dataset"] = g.int("federated", "repetitions_dataset", fallback=1)
            if kw["repetitions_dataset"] > 1:
                kw["epochs"] = int(kw["epochs"] / kw["repetitions_dataset"])
                if verbose:
                    print(
                        "Number of epochs was decreased to {:d} because of {:d} "
                        "repetitions of dataset".format(
                            kw["epochs"], kw["repetitions_dataset"]
                        )
                    )
            kw["weighted_averaging"] = g.bool("federated", "weighted_averaging", fallback=False)
            kw["precision_fractional"] = int(
                g.float("federated", "precision_fractional", fallback=16)
            )

        kw["num_threads"] = g.int("system", "num_threads", fallback=0)

        # [dp] — optional; the reference hardcodes these (train.py:326-334),
        # so absent keys reproduce its exact values
        kw["noise_multiplier"] = g.float("dp", "noise_multiplier", fallback=1.3)
        kw["max_grad_norm"] = g.float("dp", "max_grad_norm", fallback=1.0)
        kw["target_delta"] = g.float("dp", "target_delta", fallback=1e-5)
        kw["augment_multiplicity"] = g.int("dp", "augment_multiplicity",
                                           fallback=1)
        kw["parameter_ema"] = g.float("dp", "parameter_ema", fallback=0.0)

        # CLI-only flags
        if cmd_args is not None:
            if getattr(cmd_args, "training_name", None):
                kw["name"] = cmd_args.training_name
            if getattr(cmd_args, "save_file", None):
                kw["save_file"] = cmd_args.save_file
            kw["data_dir"] = getattr(cmd_args, "data_dir", "data/train")
            kw["visdom"] = bool(getattr(cmd_args, "visdom", False)) and mode == "train"
            kw["cuda"] = bool(getattr(cmd_args, "cuda", False))
            kw["websockets"] = (
                bool(getattr(cmd_args, "websockets", False)) if mode == "train" else False
            )
            kw["encrypted_inference"] = (
                bool(getattr(cmd_args, "encrypted_inference", False))
                if mode == "inference"
                else False
            )
            kw["resume_checkpoint"] = getattr(cmd_args, "resume_checkpoint", None)

        return cls(**kw)

    # ---------------------------------------------------------- round-trip

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Arguments":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Arguments":
        return cls.from_dict(json.loads(s))

    def from_previous_checkpoint(self, cmd_args: Any) -> None:
        """Re-apply inference-time CLI flags to a restored train config.

        Reference: ``torchlib/utils.py:269-280``.
        """
        self.mode = "inference"
        self.visdom = False
        if hasattr(cmd_args, "encrypted_inference"):
            self.encrypted_inference = bool(cmd_args.encrypted_inference)
        self.websockets = (
            bool(getattr(cmd_args, "websockets", False))
            if self.encrypted_inference
            else False
        )
        if getattr(cmd_args, "data_dir", None):
            self.data_dir = cmd_args.data_dir

    def __str__(self) -> str:
        rows = [(f.name, str(getattr(self, f.name)))
                for f in dataclasses.fields(self)]
        w = max(len(k) for k, _ in rows)
        return "\n".join(f"{k:<{w}}  {v}" for k, v in rows) + "\n"


class _IniGetter:
    """configparser access with reference-equivalent fallback semantics."""

    _MISSING = object()

    def __init__(self, cp: configparser.ConfigParser):
        self.cp = cp

    def _get(self, fn, section, option, fallback):
        if fallback is self._MISSING:
            return fn(section, option)
        return fn(section, option, fallback=fallback)

    def int(self, section, option, fallback=_MISSING):
        return self._get(self.cp.getint, section, option, fallback)

    def float(self, section, option, fallback=_MISSING):
        return self._get(self.cp.getfloat, section, option, fallback)

    def bool(self, section, option, fallback=_MISSING):
        return self._get(self.cp.getboolean, section, option, fallback)

    def str(self, section, option, fallback=_MISSING):
        val = self._get(self.cp.get, section, option, fallback)
        return val.strip() if isinstance(val, str) else val

