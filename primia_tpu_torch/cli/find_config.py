"""Hyperparameter search CLI: ``python -m primia_tpu_torch.cli.find_config``.

Port of ``primia_tpu/cli/find_config.py`` (the reference's
``torchlib/find_config.py``), flag-compatible with it, plus ``--device``:
the same search space (lr, end_lr, restarts, Adam betas, weight decay,
class weighting, the full augmentation block behind an ``apply albu``
gate, mixup, and, federated, repetitions/sync/weighted averaging), the
same pruning hooks (the per-epoch Matthews coefficient reported to the
study; the train loops raise ``TrialPruned``), driven by the TPE-lite
study of ``train/hpo.py``::

    python -m primia_tpu_torch.cli.find_config --n_trials 50 [--federated]
        [--data_dir DIR] [--epochs 25] [--storage PATH] [--device cuda|cpu]

Each trial is a full run of the port's train loop, on CUDA unless
``--device cpu``. As in the JAX package, a trial that raises a
``RuntimeError`` is recorded as ``failed`` and the search goes on.
"""

from __future__ import annotations

import argparse
import sys

from primia_tpu_torch import DEVICES
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.train.hpo import Study

ALBU_FLAGS = ("clahe", "randomgamma", "randombrightness", "blur", "elastic",
              "optical_distortion", "grid_distortion", "grid_shuffle", "hsv", "invert",
              "cutout", "shadow", "fog", "sun_flare", "solarize", "equalize", "grid_dropout")


def build_args(trial, cmdln) -> Arguments:
    """The trial's ``Arguments``; the draws are made in the JAX package's
    order, so the same study gives the same ``to_json()``."""
    lr = trial.suggest_loguniform("lr", 1e-5, 1e-3)
    repetitions_dataset = (
        trial.suggest_int("repetitions_dataset", 1, 3) if cmdln.federated else 1
    )
    epochs = cmdln.epochs
    if cmdln.federated:
        epochs = int(epochs // repetitions_dataset)

    a = Arguments(
        name="hpo",
        train_federated=cmdln.federated,
        data_dir=cmdln.data_dir,
        batch_size=cmdln.batch_size,
        train_resolution=cmdln.resolution,
        inference_resolution=cmdln.resolution,
        test_batch_size=10,
        test_interval=1,
        validation_split=5,
        epochs=epochs,
        lr=lr,
        end_lr=trial.suggest_loguniform("end_lr", 1e-6, lr),
        restarts=trial.suggest_int("restarts", 0, 1),
        beta1=trial.suggest_float("beta1", 0.25, 0.95),
        beta2=trial.suggest_float("beta2", 0.9, 1.0),
        weight_decay=trial.suggest_loguniform("weight_decay", 1e-12, 1e-3),
        seed=1,
        deterministic=False,
        optimizer="Adam",
        model=cmdln.model,
        pretrained=cmdln.pretrained,
        weight_classes=trial.suggest_categorical("weight_classes", [True, False]),
        pooling_type="max",
        rotation=trial.suggest_int("rotation", 0, 90),
        translate=0.0,
        scale=trial.suggest_float("scale", 0.0, 0.5),
        shear=trial.suggest_int("shear", 0, 10),
        noise_std=trial.suggest_float("noise_std", 0.0, 0.1),
        noise_prob=trial.suggest_float("noise_prob", 0.0, 1.0),
        mixup=trial.suggest_categorical("mixup", [True, False]),
        repetitions_dataset=repetitions_dataset,
        save_file="model_weights/completed_trainings.csv",
    )

    apply_albu = trial.suggest_categorical("apply albu transforms", [True, False])
    a.albu_prob = trial.suggest_float("albu_prob", 0.0, 1.0) if apply_albu else 0.0
    a.individual_albu_probs = (
        trial.suggest_float("individual_albu_probs", 0.0, 1.0) if apply_albu else 0.0
    )
    for flag in ALBU_FLAGS:
        setattr(a, flag,
                trial.suggest_categorical(flag, [True, False]) if apply_albu else False)

    if a.mixup:
        a.mixup_prob = trial.suggest_float("mixup_prob", 0.0, 1.0)
        a.mixup_lambda = None  # random lambda per batch (reference default)
    if cmdln.federated:
        a.sync_every_n_batch = trial.suggest_int("sync_every_n_batch", 1, 10)
        a.weighted_averaging = trial.suggest_categorical(
            "weighted_averaging", [True, False]
        )
        a.unencrypted_aggregation = cmdln.unencrypted_aggregation
    a.validate()
    return a


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_trials", type=int, default=50)
    p.add_argument("--federated", action="store_true")
    p.add_argument("--unencrypted_aggregation", action="store_true")
    p.add_argument("--websockets", action="store_true")
    p.add_argument("--data_dir", default="data/train")
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=200)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--model", default="resnet-18")
    p.add_argument("--pretrained", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--storage", default="model_weights/hpo_study.json")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="Where each trial trains (default cuda; without a card it raises).")
    return p


def main(argv=None) -> int:
    cmdln = build_parser().parse_args(argv)

    from primia_tpu_torch.train.loop import main as train_main

    study = Study(cmdln.storage)

    def objective(trial):
        args = build_args(trial, cmdln)
        args.websockets = cmdln.websockets
        return train_main(args, verbose=False, optuna_trial=trial, device=cmdln.device)

    best = study.optimize(objective, cmdln.n_trials, catch=(RuntimeError,))
    if best is not None:
        print(f"best trial #{best.number}: value={best.value}")
        print(best.params)
    return 0


if __name__ == "__main__":
    sys.exit(main())
