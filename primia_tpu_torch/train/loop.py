"""The training loop: datasets -> steps -> epochs -> checkpoints.

Port of the local path of ``primia_tpu/train/loop.py`` (reference
``train.py:54-552``):

- deterministic seeding, experiment naming, datasets and their
  normalisation statistics,
- the class-weighted loss, resume from a checkpoint, the LR schedule,
- an initial evaluation, then an evaluation and a checkpoint every
  ``test_interval`` epochs,
- the best model by Matthews coefficient (last occurrence of the
  maximum) copied to ``<weights_dir>/final_<exp>.pt``, the others
  deleted, and the run appended to the registry CSV.

Federated training (slice 4) and DP-SGD with its parameter EMA
(slice 5) are not ported yet and raise.
"""

from __future__ import annotations

import os
import shutil
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from primia_tpu_torch import resolve_device
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.data import (BatchLoader, ImageFolderDataset, calc_mean_std,
                                   device_prefetch, random_split, to_device_resident)
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train import metrics as M
from primia_tpu_torch.train.losses import calc_class_weights
from primia_tpu_torch.train.lr import make_scheduler
from primia_tpu_torch.train.monitor import Monitor, NullMonitor
from primia_tpu_torch.train.optim import make_optimizer
from primia_tpu_torch.train.steps import build_eval_step, build_train_step


def load_train_val(args: Arguments):
    """Datasets and normalisation statistics of the local path (reference
    ``train.py:130-193``): train = ImageFolder(data_dir), val = the
    sibling ``test`` folder when present, else a ``validation_split``
    holdout. Returns (train images, train labels, val images, val labels,
    mean, std, class names)."""
    if args.data_dir == "mnist":
        raise NotImplementedError(
            "the MNIST path (primia_tpu/data/mnist.py) is not ported yet (ROADMAP queue 1)")
    channels = 1 if not args.pretrained else 3
    train_ds = ImageFolderDataset(args.data_dir, channels=channels)
    if len(train_ds.classes) != 3:
        raise ValueError("Dataset must have exactly 3 classes: normal, bacterial and viral")
    test_dir = Path(args.data_dir).parent / "test"
    if test_dir.is_dir():
        val_ds = ImageFolderDataset(test_dir, channels=channels)
    else:
        n = len(train_ds)
        n_val = max(int(n / args.validation_split), 1)
        train_ds, val_ds = random_split(train_ds, [n - n_val, n_val], seed=args.seed)
    train_imgs, train_labels = train_ds.materialize(args.inference_resolution)
    val_imgs, val_labels = val_ds.materialize(args.inference_resolution)
    mean, std = calc_mean_std(train_imgs)
    return train_imgs, train_labels, val_imgs, val_labels, mean, std, train_ds.classes


def run_eval(eval_step, loader: BatchLoader, epoch: int, class_names, verbose: bool = True):
    """One full validation pass -> (loss, objective = 100 * MCC); prints
    the stats table (reference ``test``, ``utils.py:1354-1467``). The
    device results come to the host once, at the end of the pass."""
    losses, logits, targets, keeps = [], [], [], []
    for batch in loader:
        loss, lg = eval_step(batch.images, batch.labels, batch.mask)
        losses.append(loss)
        logits.append(lg)
        keeps.append(batch.mask > 0)
        targets.append(batch.labels)
    losses = torch.stack(losses).cpu().numpy()
    logits = [lg.cpu().numpy() for lg in logits]
    scores = np.concatenate([lg[k] for lg, k in zip(logits, keeps)])
    targets = np.concatenate([t[k] for t, k in zip(targets, keeps)])
    m = M.evaluate_predictions(targets, scores.argmax(1), scores,
                               num_classes=len(class_names))
    if verbose:
        print(M.stats_table(m["conf_matrix"], m["report"], roc_auc=m["roc_auc"],
                            matthews_coeff=m["matthews_coeff"], class_names=class_names,
                            epoch=epoch))
    return float(np.mean(losses)), m["objective"]


def main(args: Arguments, verbose: bool = True, device="cuda",
         weights_dir: str = "model_weights") -> float:
    """Trains as the config says; returns the best validation objective
    (100 * MCC). ``device`` is ``"cuda"`` (the default; raises without a
    card) or ``"cpu"``."""
    if args.train_federated:
        raise NotImplementedError(
            "federated training is not ported yet (ROADMAP queue 1, slice 4)")
    if args.differentially_private:
        raise NotImplementedError("DP-SGD is not ported yet (ROADMAP queue 1, slice 5)")
    device = resolve_device(device) if isinstance(device, str) else torch.device(device)

    timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_name = "{:s}_{:s}_{:s}".format("vanilla", args.data_dir.replace("/", ""), timestamp)
    mon = Monitor(exp_name) if args.visdom else NullMonitor()
    if args.visdom and verbose:
        print(f"Live dashboard: {mon.html}")

    (train_imgs, train_labels, val_imgs, val_labels, mean, std,
     class_names) = load_train_val(args)
    num_classes = len(class_names)

    seed = args.seed if args.deterministic else int.from_bytes(os.urandom(4), "little")
    torch.manual_seed(seed)
    model = create_model(args, num_classes=num_classes, device="cpu").to(device)
    gen = torch.Generator(device=device).manual_seed(seed)

    cw = calc_class_weights(train_labels, num_classes) if args.weight_classes else None
    optimizer = make_optimizer(args, model)
    scheduler = make_scheduler(args)

    start_at_epoch = 1
    if args.resume_checkpoint:
        # reference train.py:345-389, the (x -> local) half
        state = ckpt.load_model(args.resume_checkpoint)
        start_at_epoch = int(state["epoch"]) + 1
        msd = state["model_state_dict"]
        model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
        osd = state["optim_state_dict"]
        if bool(getattr(state["args"], "train_federated", False)) or isinstance(osd, dict):
            # federated checkpoints carry a per-worker optimizer dict; a
            # local continuation starts the optimizer fresh
            if verbose:
                print("Resuming a federated checkpoint locally: optimizer state reset")
        elif osd is not None:
            optimizer.load_jax_state(osd)
        if verbose:
            print(f"Resuming from {args.resume_checkpoint} at epoch {start_at_epoch}")

    train_step = build_train_step(model, optimizer, args, mean, std, cw, device)
    eval_step = build_eval_step(model, args, mean, std, cw, device)

    # datasets live on the card when they fit: batches become gathers there
    train_loader = BatchLoader(to_device_resident(train_imgs, device), train_labels,
                               args.batch_size, shuffle=True, seed=args.seed, pad_final=False)
    # eval results do not depend on the batch size (eval-mode BN, masked
    # padding), so tiny test_batch_size values are floored at 64
    val_loader = BatchLoader(to_device_resident(val_imgs, device), val_labels,
                             max(args.test_batch_size, 64), shuffle=False, pad_final=True)

    run_eval(eval_step, val_loader, start_at_epoch - 1, class_names, verbose)

    matthews_scores, model_paths = [], []
    os.makedirs(weights_dir, exist_ok=True)
    for epoch in range(start_at_epoch, args.epochs + 1):
        lr = scheduler.get_lr(epoch - 1)
        step_losses = [train_step(gen, b.images, b.labels, b.mask, lr)
                       for b in device_prefetch(train_loader, device)]
        epoch_loss = float(torch.stack(step_losses).mean())
        mon.add_scalar("train_loss", epoch, epoch_loss)
        mon.add_scalar("lr", epoch, float(lr))
        if verbose:
            print("Train Epoch: {} \tLoss: {:.6f}".format(epoch, epoch_loss))
        if (epoch % args.test_interval) == 0:
            val_loss, matthews = run_eval(eval_step, val_loader, epoch, class_names, verbose)
            mon.add_scalar("val_loss", epoch, float(val_loss))
            mon.add_scalar("val_mcc", epoch, float(matthews))
            model_path = os.path.join(weights_dir, "{:s}_epoch_{:03d}.pt".format(
                exp_name, epoch * (args.repetitions_dataset or 1)))
            ckpt.save_model(model_path, epoch=epoch, model=model, args=args,
                            val_mean_std=(mean, std), opt_state=optimizer.state_to_jax())
            matthews_scores.append(matthews)
            model_paths.append(model_path)

    if not matthews_scores:
        if verbose:
            print(f"Nothing to do: resume epoch {start_at_epoch} is past epochs={args.epochs}")
        return 0.0

    # last occurrence of the highest score wins (reference train.py:519-533)
    rev = np.array(matthews_scores)[::-1]
    best_score_idx = int(np.argmax(rev))
    highest_score = len(rev) - best_score_idx - 1
    if verbose:
        print("Highest matthews coefficient was {:.1f}% in epoch {:d}".format(
            rev[best_score_idx], (highest_score + 1) * args.test_interval))
    shutil.copyfile(model_paths[highest_score],
                    os.path.join(weights_dir, f"final_{exp_name}.pt"))
    if args.save_file:
        ckpt.save_config_results(args, float(rev[best_score_idx]), timestamp)
    for p in model_paths:
        os.remove(p)
    return float(rev[best_score_idx])
