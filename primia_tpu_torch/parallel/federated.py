"""Federated training as a simulation on one card — workload 3.

Port of ``primia_tpu/parallel/federated.py`` (reference
``torchlib/utils.py:936-1233``): per-worker model replicas stepped
round-robin over their own shards; every ``sync_every_n_batch`` batches
and at each epoch's end the models are aggregated (MPC secure
aggregation, or plain FedAvg under ``--unencrypted_aggregation``) and
re-broadcast, and the optimizers reset unless ``keep_optim_dict``.

The node axis is N modules, not a ``vmap``. The JAX package vmaps one
train step over node-stacked parameters; here each node has its own
module (all built from the same initial weights), its own optimizer and
train-step closure and its own ``torch.Generator``, seeded from
(seed, 99, node). ``torch.func.vmap`` cannot batch through the ctypes
launches of the warp and CLAHE kernels, through the ``autograd.Function``
of the opt-in kernels, or through batch norm's in-place running
statistics. A federated step runs the active nodes' steps in node order
on one stream: the reference's round-robin, the same independent
updates. A node whose shard has run out does not step, which is the JAX
package's whole-state mask. Aggregation stacks the nodes' tensors leaf by
leaf on the card (which bounds the peak), aggregates them in share space
there and copies the result into every node's parameters and buffers in
place.

Under ``differentially_private`` every node's step is DP-SGD
(``train/dp.py:select_train_step``; each node's own generator draws its
own noise), each node's epsilon is printed after each epoch, and with
``0 < parameter_ema < 1`` the aggregated model's moving average across
aggregation rounds is evaluated and saved (its raw parameters beside it,
under ``raw_params``), as the JAX package's loop does.

``--websockets`` trains against live grid nodes instead
(:func:`main_federated_ws`, ``serve/*``): each node runs its own steps on
its own shard and only parameters cross the wire.
"""

from __future__ import annotations

import copy
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from primia_tpu_torch import resolve_device
from primia_tpu_torch.config import Arguments, read_worker_config
from primia_tpu_torch.data import (Batch, BatchLoader, ImageFolderDataset, calc_mean_std,
                                   device_prefetch, to_device_resident)
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.aggregation import (_keystr, fedavg_leaf, node_weights,
                                              secure_average_stats)
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, jax_leaf_paths, to_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.loop import report_or_prune, run_eval
from primia_tpu_torch.train.losses import calc_class_weights
from primia_tpu_torch.train.lr import make_scheduler
from primia_tpu_torch.train.dp import parameter_ema, rdp_epsilon, select_train_step
from primia_tpu_torch.train.monitor import Monitor, NullMonitor
from primia_tpu_torch.train.optim import make_optimizer
from primia_tpu_torch.train.steps import build_eval_step


def discover_workers(args: Arguments) -> List[str]:
    """Worker names: ``configs/websetting/config.csv`` when present
    (reference ``setup_pysyft``), else the ``worker*`` folders under
    ``data_dir``. The crypto provider row is split off as in the
    reference (``utils.py:525-541``)."""
    csv_path = Path("configs/websetting/config.csv")
    if csv_path.is_file():
        cfg = read_worker_config(csv_path)
        names = [w for w in cfg if w != "crypto_provider"]
        if not args.unencrypted_aggregation and "crypto_provider" not in cfg:
            raise AssertionError("No crypto provider in configuration")
        return names
    root = Path(args.data_dir)
    names = sorted(
        d.name for d in root.iterdir() if d.is_dir() and d.name.startswith("worker")
    )
    if not names:
        raise FileNotFoundError(
            f"no worker folders under {root} and no configs/websetting/config.csv"
        )
    return names


def setup_federated(args: Arguments, verbose: bool = True, device="cuda"):
    """Load per-worker shards + validation set; securely average stats.

    Data layout mirrors the reference: ``{data_dir}/worker{i}`` per
    worker, ``{data_dir}/validation`` for the local val set
    (``utils.py:643-660,814-826``). The statistics are averaged in share
    space on ``device`` (``"cuda"``, the default, raises without a card;
    or ``"cpu"``). Returns (worker names, per-node images, per-node
    labels, val images, val labels, mean, std, class names)."""
    device = resolve_device(device) if isinstance(device, str) else torch.device(device)
    worker_names = discover_workers(args)
    channels = 1 if not args.pretrained else 3
    node_imgs, node_labels, means, stds = [], [], [], []
    class_names = None
    for i, _name in enumerate(worker_names):
        ds = ImageFolderDataset(Path(args.data_dir) / f"worker{i + 1}", channels=channels)
        if len(ds.classes) != 3:
            raise ValueError(
                "We can only handle data that has 3 classes: normal, bacterial and viral")
        class_names = ds.classes
        imgs, labels = ds.materialize(args.inference_resolution)
        m, s = calc_mean_std(imgs)
        node_imgs.append(imgs)
        node_labels.append(labels)
        means.append(m)
        stds.append(s)

    frac = args.precision_fractional
    mean = secure_average_stats((args.seed, 1), means, frac, device).cpu().numpy()
    std = secure_average_stats((args.seed, 2), stds, frac, device).cpu().numpy()

    val_ds = ImageFolderDataset(Path(args.data_dir) / "validation", channels=channels)
    val_imgs, val_labels = val_ds.materialize(args.inference_resolution)
    if verbose:
        total = sum(len(x) for x in node_imgs)
        print(f"Found a total dataset with {total:d} samples on remote workers")
        print(f"Found a total validation set with {len(val_imgs):d} samples (locally)")
    return worker_names, node_imgs, node_labels, val_imgs, val_labels, mean, std, class_names


class FederatedNodes:
    """N replicas of ``model``, each with its own optimizer, train step (the
    one :func:`select_train_step` picks, DP-SGD under
    ``differentially_private``) and generator, and their aggregation.

    ``step(batches, lr)`` runs node i's train step on ``batches[i]``, in
    node order, and skips a node whose batch is None; it returns the
    losses as device tensors (None for a node that did not step).
    ``aggregate(weights, key)`` averages every parameter and batch-norm
    buffer over the nodes, leaf by leaf on their device (plain FedAvg when
    ``key`` is None, else secure aggregation with shares seeded from
    ``key``), and copies the average into every node in place.
    """

    def __init__(self, args: Arguments, model: torch.nn.Module, n_nodes: int, mean, std,
                 class_weights: Optional[np.ndarray] = None, device="cuda"):
        device = torch.device(device)
        self.models = [model] + [copy.deepcopy(model) for _ in range(n_nodes - 1)]
        self.optimizers = [make_optimizer(args, m) for m in self.models]
        self.steps = [select_train_step(m, o, args, mean, std, class_weights, device)
                      for m, o in zip(self.models, self.optimizers)]
        self.device = device
        self.gens = [S.stream(device, args.seed, 99, i) for i in range(n_nodes)]
        self.leaves = jax_leaf_paths(model)
        # detached views of each node's parameters and buffers: copy_ into
        # them writes the module's own storage
        self._tensors = [m.state_dict() for m in self.models]
        self.frac_bits = args.precision_fractional

    def step(self, batches: Sequence[Optional[Batch]], lr: float) -> List[Optional[torch.Tensor]]:
        return [None if b is None else step(gen, b.images, b.labels, b.mask, lr)
                for step, gen, b in zip(self.steps, self.gens, batches)]

    @torch.no_grad()
    def aggregate(self, weights, key: Optional[Sequence[int]] = None) -> None:
        weights = node_weights(weights, self.device)
        for path, name in self.leaves:
            out = fedavg_leaf(key, path, torch.stack([t[name] for t in self._tensors]),
                              weights, self.frac_bits)
            for t in self._tensors:
                t[name].copy_(out)

    def reset_optimizers(self) -> None:
        for o in self.optimizers:
            o.reset()


def _cycle(loader: BatchLoader, device) -> Iterator[Batch]:
    """The loader's batches, pass after pass (a new shuffle each pass, as
    the JAX loop's ``iter(loader)`` after ``StopIteration``), with the next
    batches already on their way to ``device``."""
    while True:
        yield from device_prefetch(loader, device)


def aggregate_wire(results, worker_names, leaves, weights, key, frac_bits, device):
    """Average the nodes' ``train_round`` replies leaf by leaf on ``device``
    (plain FedAvg when ``key`` is None, else secure aggregation with
    shares seeded from ``key``). ``leaves``: :func:`jax_leaf_paths` of the
    model. Returns the average as the wire's flat trees, ``{"params":
    {keystr: array}, "model_state": {...}}``, in the JAX layout."""
    w = node_weights(weights, device)
    out = {"params": {}, "model_state": {}}
    for path, _ in leaves:
        wire, key_str = ("params" if path[0] == "params" else "model_state"), _keystr(path[1:])
        stacked = torch.stack([torch.from_numpy(np.asarray(results[n][wire][key_str]))
                               for n in worker_names]).to(device)
        out[wire][key_str] = fedavg_leaf(key, path, stacked, w, frac_bits).cpu().numpy()
    return out


def main_federated_ws(args: Arguments, verbose: bool = True, device="cuda",
                      weights_dir: str = "model_weights",
                      config_csv: str = "configs/websetting/config.csv") -> float:
    """Federated training against live grid nodes (``--websockets``), as
    ``primia_tpu/parallel/federated.py:main_federated_ws``: each round is
    one ``train_round`` RPC a node, fanned out on threads; the node runs
    ``sync_every_n_batch`` steps on its own shard and returns its
    parameters, which are averaged here on ``device`` (secure aggregation,
    or plain FedAvg under ``--unencrypted_aggregation``) and sent out
    again. The nodes' normalization statistics are averaged in share
    space; evaluation runs here on the local ``validation`` folder, and the
    checkpoint has the JAX layout. Each aggregation draws fresh shares,
    numbered across the whole run (the JAX loop numbers them by the round
    within an epoch, so its masks repeat from epoch to epoch)."""
    from primia_tpu_torch.serve.client import clients_from_csv
    from primia_tpu_torch.serve.node import _flatten, _unflatten

    device = resolve_device(device) if isinstance(device, str) else torch.device(device)
    timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_name = "federated_{:s}_{:s}".format(args.data_dir.replace("/", ""), timestamp)
    mon = Monitor(exp_name) if args.visdom else NullMonitor()
    if args.visdom and verbose:
        print(f"Live dashboard: {mon.html}")
    clients = {w: c for w, c in clients_from_csv(config_csv).items()
               if w != "crypto_provider"}
    worker_names = list(clients)
    n_nodes = len(worker_names)

    frac = args.precision_fractional
    means = [c.get_obj("#datamean") for c in clients.values()]
    stds = [c.get_obj("#datastd") for c in clients.values()]
    mean = secure_average_stats((args.seed, 1), means, frac, device).cpu().numpy()
    std = secure_average_stats((args.seed, 2), stds, frac, device).cpu().numpy()

    channels = 1 if not args.pretrained else 3
    val_ds = ImageFolderDataset(Path(args.data_dir) / "validation", channels=channels)
    val_imgs, val_labels = val_ds.materialize(args.inference_resolution)
    class_names = val_ds.classes
    num_classes = len(class_names)

    torch.manual_seed(args.seed)
    model = create_model(args, num_classes=num_classes, device="cpu").to(device)
    leaves = jax_leaf_paths(model)
    params, state = (_flatten(t) for t in to_jax_tree(model))
    eval_step = build_eval_step(model, args, mean, std, None, device)
    val_loader = BatchLoader(to_device_resident(val_imgs, device), val_labels,
                             max(args.test_batch_size, 64), shuffle=False, pad_final=True)
    scheduler = make_scheduler(args)

    matthews_scores, model_paths = [], []
    os.makedirs(weights_dir, exist_ok=True)
    steps_round = max(args.sync_every_n_batch, 1)
    reps = max(args.repetitions_dataset, 1)
    agg_round = 0
    with ThreadPoolExecutor(max_workers=n_nodes) as pool:
        for epoch in range(1, args.epochs + 1):
            lr = scheduler.get_lr(epoch - 1)
            counts, losses, rounds = {}, [], 1
            for r in range(1000):  # bounded by the largest shard
                msg = {"type": "train_round", "args": args.to_json(), "params": params,
                       "model_state": state, "n_steps": steps_round, "lr": lr,
                       "seed": args.seed + epoch * 1000 + r, "num_classes": num_classes}
                results = {}
                for w, out in zip(worker_names,
                                  pool.map(lambda c: c.send(msg), clients.values())):
                    if "error" in out:
                        raise RuntimeError(f"{w}: {out['error']}")
                    results[w] = out
                    counts[w] = out["n_batches"] * reps
                    losses.append(out["loss"])
                total = sum(counts.values())
                agg_w = (np.array([counts[w] / total for w in worker_names])
                         if args.weighted_averaging else np.full(n_nodes, 1.0 / n_nodes))
                agg_round += 1
                key = None if args.unencrypted_aggregation else (args.seed, 777, agg_round)
                avg = aggregate_wire(results, worker_names, leaves, agg_w, key, frac, device)
                params, state = avg["params"], avg["model_state"]
                rounds = max(1, int(np.ceil(max(counts.values()) / steps_round)))
                if r + 1 >= rounds:
                    break
            if verbose:
                print("Train Epoch: {} \tLoss: {:.6f}".format(epoch, float(np.mean(losses))))
            if args.differentially_private and verbose:
                # nodes clip and noise locally; each node's account from what
                # crossed the wire: sampling rate 1/n_batches, rounds *
                # steps_round steps an epoch
                per_node = []
                for w in worker_names:
                    nb = max(int(results[w]["n_batches"]), 1)
                    eps, alpha = rdp_epsilon(noise_multiplier=args.noise_multiplier,
                                             sample_rate=min(1.0 / nb, 1.0),
                                             steps=epoch * rounds * steps_round,
                                             delta=args.target_delta)
                    per_node.append((w, eps, alpha))
                worst = max(per_node, key=lambda t: t[1])
                print("(eps = {:.2f}, delta = {}) at alpha = {} [worst node: {}; "
                      "per-node eps: {}]".format(worst[1], args.target_delta, worst[2],
                                                 worst[0], ", ".join(
                                                     f"{w}={e:.2f}" for w, e, _ in per_node)))
            if (epoch % args.test_interval) == 0:
                model.load_state_dict(from_jax_tree(_unflatten(params), _unflatten(state)))
                _, matthews = run_eval(eval_step, val_loader, epoch, class_names, verbose)
                model_path = os.path.join(weights_dir, "{:s}_epoch_{:03d}.pt".format(
                    exp_name, epoch * reps))
                ckpt.save_model(model_path, epoch=epoch, model=model, args=args,
                                val_mean_std=(mean, std),
                                opt_state={w: None for w in worker_names})
                matthews_scores.append(matthews)
                model_paths.append(model_path)
    for c in clients.values():
        c.close()

    if not matthews_scores:
        if verbose:
            print(f"Nothing to do: no epochs ran (epochs={args.epochs})")
        return 0.0
    rev = np.array(matthews_scores)[::-1]
    best_idx = int(np.argmax(rev))
    highest = len(rev) - best_idx - 1
    shutil.copyfile(model_paths[highest], os.path.join(weights_dir, f"final_{exp_name}.pt"))
    if args.save_file:
        ckpt.save_config_results(args, float(rev[best_idx]), timestamp)
    for p in model_paths:
        os.remove(p)
    return float(rev[best_idx])


def main_federated(args: Arguments, verbose: bool = True, device="cuda",
                   weights_dir: str = "model_weights", optuna_trial=None) -> float:
    """Trains the simulated federation as the config says; returns the
    best validation objective (100 * MCC). ``device`` is ``"cuda"`` (the
    default; raises without a card) or ``"cpu"``. ``optuna_trial`` gets
    each evaluation's objective at step ``epoch * repetitions_dataset``
    and may prune the run (``train/loop.py:report_or_prune``); as in the
    JAX package, ``--websockets`` runs take none."""
    if args.websockets:
        return main_federated_ws(args, verbose=verbose, device=device, weights_dir=weights_dir)
    device = resolve_device(device) if isinstance(device, str) else torch.device(device)

    timestamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    exp_name = "federated_{:s}_{:s}".format(args.data_dir.replace("/", ""), timestamp)
    mon = Monitor(exp_name) if args.visdom else NullMonitor()
    if args.visdom and verbose:
        print(f"Live dashboard: {mon.html}")

    (worker_names, node_imgs, node_labels, val_imgs, val_labels, mean, std,
     class_names) = setup_federated(args, verbose, device)
    n_nodes = len(worker_names)
    num_classes = len(class_names)

    torch.manual_seed(args.seed)
    model = create_model(args, num_classes=num_classes, device="cpu").to(device)
    cw = None
    if args.weight_classes:
        cw = calc_class_weights(np.concatenate(node_labels), num_classes)
    scheduler = make_scheduler(args)

    start_at_epoch = 1
    if args.resume_checkpoint:
        # the (x -> federated) half of the reference's 4-way resume
        # (train.py:345-389): the checkpoint's model goes to every node;
        # per-worker optimizer state is restored only when it was saved
        # per worker AND keep_optim_dict asks for it
        ck = ckpt.load_model(args.resume_checkpoint)
        start_at_epoch = int(ck["epoch"]) + 1
        msd = ck["model_state_dict"]
        # a DP + EMA checkpoint's model is the average: the nodes continue
        # from the raw parameters saved beside it
        model.load_state_dict(from_jax_tree(ck.get("raw_params", msd["params"]),
                                            msd["state"]))
        if verbose:
            print(f"Resuming from {args.resume_checkpoint} at epoch {start_at_epoch}")

    # replicas, all from the same weights (the reference broadcasts one
    # model to every worker)
    nodes = FederatedNodes(args, model, n_nodes, mean, std, cw, device)
    if args.resume_checkpoint and args.keep_optim_dict:
        osd = ck["optim_state_dict"]
        if (isinstance(osd, dict) and set(osd) >= set(worker_names)
                and all(osd[w] is not None for w in worker_names)):
            for w, opt in zip(worker_names, nodes.optimizers):
                opt.load_jax_state(osd[w])
            if verbose:
                print("Restored per-worker optimizer state")

    # node shards live on the card: batches are gathers there
    loaders = [
        BatchLoader(to_device_resident(node_imgs[i], device), node_labels[i], args.batch_size,
                    shuffle=True, seed=args.seed + i, pad_final=True)
        for i in range(n_nodes)
    ]
    feeds = [_cycle(loader, device) for loader in loaders]
    num_batches = [len(loader) * max(args.repetitions_dataset, 1) for loader in loaders]
    total_batches = sum(num_batches)
    if args.weighted_averaging:
        agg_weights = np.array([nb / total_batches for nb in num_batches])
    else:
        agg_weights = np.full(n_nodes, 1.0 / n_nodes)

    val_loader = BatchLoader(to_device_resident(val_imgs, device), val_labels,
                             max(args.test_batch_size, 64), shuffle=False, pad_final=True)
    eval_step = build_eval_step(nodes.models[0], args, mean, std, cw, device)

    # DP parameter averaging of the aggregated model across aggregation
    # rounds; it starts at the first aggregation (or from a checkpoint's
    # average), and until then the raw model is evaluated
    ema = parameter_ema(args, nodes.models[0], started=False)
    if ema is not None and args.resume_checkpoint and "raw_params" in ck:
        ema.model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
        ema.started = True
    ema_eval_step = None if ema is None else build_eval_step(ema.model, args, mean, std, cw,
                                                             device)

    def evaluated():
        """(the model evaluated and saved, its eval step)"""
        if ema is not None and ema.started:
            return ema.model, ema_eval_step
        return nodes.models[0], eval_step

    agg_round = 0  # fresh dealer randomness per sync: repeated masks
    # would let a party cancel them across rounds and see update deltas

    def aggregate() -> None:
        nonlocal agg_round
        agg_round += 1
        key = None if args.unencrypted_aggregation else (args.seed, 777, agg_round)
        nodes.aggregate(agg_weights, key)
        if not args.keep_optim_dict:
            nodes.reset_optimizers()
        if ema is not None:
            ema.update()

    # after aggregate() every replica holds the aggregated model: node 0's
    # (or its average under DP) is the one evaluated and saved
    run_eval(evaluated()[1], val_loader, 0, class_names, verbose)

    matthews_scores, model_paths = [], []
    os.makedirs(weights_dir, exist_ok=True)
    reps = max(args.repetitions_dataset, 1)
    # checkpoints are written in the background; every write has landed
    # when the block ends, also when it ends in TrialPruned or an error
    with ckpt.BackgroundWriter() as writer:
        for epoch in range(start_at_epoch, args.epochs + 1):
            lr = scheduler.get_lr(epoch - 1)
            if not args.keep_optim_dict:
                nodes.reset_optimizers()
            losses = []  # device tensors until the epoch's end
            for batch_idx in range(max(num_batches)):
                batches = [next(feeds[i]) if batch_idx < num_batches[i] else None
                           for i in range(n_nodes)]
                losses += [loss for loss in nodes.step(batches, lr) if loss is not None]
                if batch_idx > 0 and batch_idx % args.sync_every_n_batch == 0:
                    aggregate()
            aggregate()
            epoch_loss = float(torch.stack(losses).double().mean())
            mon.add_scalar("train_loss", epoch, epoch_loss)
            mon.add_scalar("lr", epoch, float(lr))
            if verbose:
                print("Train Epoch: {} \tLoss: {:.6f}".format(epoch, epoch_loss))
            if args.differentially_private and verbose:
                # per-node accounting: each node's mechanism touches only its
                # own shard; the line leads with the worst node
                per_node = []
                for w, imgs, nb in zip(worker_names, node_imgs, num_batches):
                    eps, alpha = rdp_epsilon(
                        noise_multiplier=args.noise_multiplier,
                        sample_rate=min(args.batch_size / max(len(imgs), 1), 1.0),
                        steps=epoch * nb, delta=args.target_delta)
                    per_node.append((w, eps, alpha))
                worst = max(per_node, key=lambda t: t[1])
                print("(eps = {:.2f}, delta = {}) at alpha = {} [worst node: {}; "
                      "per-node eps: {}]".format(
                          worst[1], args.target_delta, worst[2], worst[0],
                          ", ".join(f"{w}={e:.2f}" for w, e, _ in per_node)))

            if (epoch % args.test_interval) == 0:
                saved, saved_eval = evaluated()
                val_loss, matthews = run_eval(saved_eval, val_loader, epoch, class_names,
                                              verbose)
                mon.add_scalar("val_loss", epoch, float(val_loss))
                mon.add_scalar("val_mcc", epoch, float(matthews))
                model_path = os.path.join(weights_dir, "{:s}_epoch_{:03d}.pt".format(
                    exp_name, epoch * reps))
                report_or_prune(optuna_trial, matthews, epoch * reps)
                writer.save_model(
                    model_path, epoch=epoch, model=saved, args=args, val_mean_std=(mean, std),
                    opt_state={w: o.state_to_jax(on_device=True)
                               for w, o in zip(worker_names, nodes.optimizers)},
                    raw_model=None if saved is nodes.models[0] else nodes.models[0])
                matthews_scores.append(matthews)
                model_paths.append(model_path)

    if not matthews_scores:
        # zero effective epochs (epochs < repetitions_dataset divides to
        # 0) or no test interval hit: nothing was trained/selected
        if verbose:
            print(f"Nothing to do: no epochs ran (epochs={args.epochs})")
        return 0.0

    # last occurrence of the highest score wins (reference train.py:519-533)
    rev = np.array(matthews_scores)[::-1]
    best_idx = int(np.argmax(rev))
    highest = len(rev) - best_idx - 1
    if verbose:
        print("Highest matthews coefficient was {:.1f}% in epoch {:d}".format(
            rev[best_idx], (highest + 1) * args.test_interval * reps))
    shutil.copyfile(model_paths[highest], os.path.join(weights_dir, f"final_{exp_name}.pt"))
    if args.save_file:
        ckpt.save_config_results(args, float(rev[best_idx]), timestamp)
    for p in model_paths:
        os.remove(p)
    return float(rev[best_idx])
