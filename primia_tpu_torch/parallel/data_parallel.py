"""Data parallelism over ranks: one site's train step on many devices.

Port of ``primia_tpu/parallel/data_parallel.py``. The JAX package jits the
one-device step with the batch sharded over a mesh axis, and XLA
partitions it: the sharded step computes what the one-device step
computes. Here each rank runs the port's step on its rows of the batch,
and the places where a row meets the rest of the batch are written out:

- the augmentation draws every random number for the whole batch from
  the generator (seeded alike on every rank) and keeps this rank's rows
  (``ops/augment.py``: ``global_batch``);
- MixUp draws λ and the permutation for the whole batch, and the
  augmented rows are gathered from every rank, so a row's partner may lie
  on another rank;
- train-mode batch norm takes the whole batch's statistics
  (``nn/core.py:Norm.ranks``): the default path merges the ranks' means
  and centred sums of squares forward and sums the gradient's channel
  sums backward; the switched path (``PRIMIA_PALLAS_BN=1``) sums K8's
  partial sums over the ranks before its finalize launch, both ways;
- the loss divides this rank's rows' sum by the whole batch's
  normaliser, so the gradients are summed over the ranks (one all-reduce
  of one flat float32 buffer, the loss riding at its end), and every rank
  makes the same optimizer update.

With one rank on the axis the steps are the one-device steps.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from primia_tpu_torch.nn.core import Norm
from primia_tpu_torch.ops.augment import AugmentConfig, build_augment_fn, normalize_only
from primia_tpu_torch.parallel.multihost import RankMesh, all_gather, all_reduce_
from primia_tpu_torch.train import losses
from primia_tpu_torch.train.steps import (_center_crop, _class_weights, _full_f32, _on,
                                          build_eval_step, build_train_step,
                                          resolve_compute_dtype, uses_onehot_loss)


def data_parallel_mesh(n_devices: Optional[int] = None, axis: str = "data") -> RankMesh:
    """A 1-D mesh over the first ``n_devices`` ranks (all of them by
    default; one device a rank)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return RankMesh(np.arange(n_devices or world), (axis,))


class BatchRanks:
    """The ranks of one mesh axis as a batch norm sees them: ``sum_`` adds a
    tensor over them in place, ``gather`` stacks theirs, ``size`` counts
    them."""

    def __init__(self, group, size: int):
        self.group, self.size = group, size

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_(t, self.group)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather(t, self.group)


def _rows(mesh: RankMesh, axis: str, batch: int) -> slice:
    n = mesh.shape[axis]
    if batch % n:
        raise ValueError(f"a batch of {batch} does not split over {n} ranks")
    b = batch // n
    return slice(mesh.index(axis) * b, (mesh.index(axis) + 1) * b)


def _numerator(logits, labels, y_oh, mask, w, onehot):
    """This rank's rows' part of the loss's sum."""
    if onehot:
        return losses.cross_entropy_one_hot(logits, y_oh, weight=w, reduction="sum",
                                            sample_mask=mask)
    per = -torch.gather(torch.log_softmax(logits, dim=1), 1, labels[:, None])[:, 0]
    wl = (w[labels] if w is not None else torch.ones_like(per)) * mask
    return torch.sum(per * wl)


def _denominator(labels, mask, w, onehot):
    """The whole batch's normaliser (``train/losses.py``'s masked means)."""
    if onehot:
        return torch.clamp(torch.sum(mask), min=1.0)
    wl = (w[labels] if w is not None else torch.ones_like(mask)) * mask
    return torch.clamp(torch.sum(wl), min=1e-12)


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """(B, C, H, W) ``channels_last`` from every rank's rows, in rank order,
    gathered in that memory layout."""
    g = all_gather(x.permute(0, 2, 3, 1).contiguous(), group)
    return g.flatten(0, 1).permute(0, 3, 1, 2)


def shard_train_step(model: torch.nn.Module, optimizer, args, mean, std,
                     class_weights: Optional[np.ndarray] = None, *, mesh: RankMesh,
                     axis: str = "data", device="cuda") -> Callable:
    """The train step, data parallel over the mesh's ``axis``.

    Signature of ``train/steps.py:build_train_step``'s product:
    ``step(gen, images_u8, labels, mask, lr) -> loss``, called on every
    rank with the **whole** batch (numpy arrays or host tensors) and a
    ``gen`` on ``device`` in the same state on every rank. Each rank copies
    only its rows of the images to ``device``. Returns the whole batch's
    loss on every rank. The model's batch norms take the whole batch's
    statistics from here on (``Norm.ranks``). Start every rank from the
    same weights (:func:`replicate`)."""
    n = mesh.shape[axis]
    if n == 1:
        return build_train_step(model, optimizer, args, mean, std, class_weights, device)
    device = torch.device(device)
    group = mesh.group(axis)
    ranks = BatchRanks(group, n)
    for m in model.modules():
        if isinstance(m, Norm) and m.kind == "batch":
            m.ranks = ranks
    augment = build_augment_fn(AugmentConfig.from_args(args), mean, std, model.in_channels,
                               device)
    w = _class_weights(args, class_weights, device)
    onehot = uses_onehot_loss(args)
    nc = model.num_classes
    cdtype = resolve_compute_dtype(args, device)
    _full_f32(device)
    sizes = [p.numel() for p in optimizer.params]

    def step(gen: torch.Generator, images_u8, labels, mask, lr: float) -> torch.Tensor:
        model.train()
        B = len(images_u8)
        rows = _rows(mesh, axis, B)
        x = augment(gen, _on(device, images_u8[rows]), global_batch=B, offset=rows.start)
        labels_g = _on(device, labels, torch.long)
        mask_g = _on(device, mask, torch.float32)
        y_g = losses.to_one_hot(labels_g, nc)
        y = y_g[rows]
        if args.mixup:
            lam, perm = losses.mixup_draws(gen, B, args.mixup_lambda, args.mixup_prob)
            partner = perm[rows]
            x = lam * x + (1.0 - lam) * _gather_rows(x, group)[partner]
            y = lam * y + (1.0 - lam) * y_g[partner]
            x = x.contiguous(memory_format=torch.channels_last)
        with torch.autocast(device.type, dtype=torch.bfloat16,
                            enabled=cdtype == torch.bfloat16):
            logits = model(x)
        num = _numerator(logits.float(), labels_g[rows], y, mask_g[rows], w, onehot)
        loss = num / _denominator(labels_g, mask_g, w, onehot)
        grads = torch.autograd.grad(loss, optimizer.params)
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        all_reduce_(flat, group)
        optimizer.update([g.view_as(p) for g, p in
                          zip(flat[:-1].split(sizes), optimizer.params)], lr)
        return flat[-1]

    return step


def shard_eval_step(model: torch.nn.Module, args, mean, std,
                    class_weights: Optional[np.ndarray] = None, *, mesh: RankMesh,
                    axis: str = "data", device="cuda") -> Callable:
    """``eval_step(images_u8, labels, mask) -> (loss, logits)`` with the
    forward split over the mesh's ``axis``: each rank runs its rows (eval
    mode: running statistics, nothing crosses ranks) and the logits are
    gathered back, (B, num_classes) on every rank with the whole batch's
    loss. Called with the whole batch, as :func:`shard_train_step`."""
    n = mesh.shape[axis]
    if n == 1:
        return build_eval_step(model, args, mean, std, class_weights, device)
    device = torch.device(device)
    group = mesh.group(axis)
    w = _class_weights(args, class_weights, device)
    onehot = uses_onehot_loss(args)
    nc = model.num_classes
    _full_f32(device)

    @torch.no_grad()
    def step(images_u8, labels, mask):
        model.eval()
        rows = _rows(mesh, axis, len(images_u8))
        x = _center_crop(_on(device, images_u8[rows]), args.train_resolution)
        logits = model(normalize_only(x, mean, std, model.in_channels))
        labels_g = _on(device, labels, torch.long)
        mask_g = _on(device, mask, torch.float32)
        num = _numerator(logits, labels_g[rows], losses.to_one_hot(labels_g[rows], nc),
                         mask_g[rows], w, onehot)
        loss = all_reduce_(num.reshape(1), group)[0] / _denominator(labels_g, mask_g, w, onehot)
        return loss, all_gather(logits.contiguous(), group).flatten(0, 1)

    return step


def replicate(model: torch.nn.Module, mesh: RankMesh, axis: str = "data") -> torch.nn.Module:
    """The same weights on every rank of the axis: parameters and buffers
    broadcast from its first rank, in place. Returns ``model``."""
    group = mesh.group(axis)
    if group is None:
        return model
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t.data, src, group=group)
    return model


def shard_batch(tree, mesh: RankMesh, axis: str = "data"):
    """This rank's rows (leading dim) of every array of ``tree`` (dicts,
    lists and tuples of numpy arrays or tensors)."""
    if isinstance(tree, dict):
        return {k: shard_batch(v, mesh, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(v, mesh, axis) for v in tree)
    return tree[_rows(mesh, axis, len(tree))]
