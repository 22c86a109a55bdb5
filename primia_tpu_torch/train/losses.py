"""Losses, MixUp and class weighting.

Port of ``primia_tpu/train/losses.py`` (reference ``torchlib/utils.py:
305-513``). MixUp is the permutation form of the JAX package: each sample
mixes with a random partner under one shared λ, so the batch keeps its
size. Its draws (``mixup``) are kept apart from its math
(``mixup_with``), so tests can hand both packages the same λ and
permutation.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def to_one_hot(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Integer labels -> float32 one-hot (reference ``To_one_hot``)."""
    return F.one_hot(labels.long(), num_classes).float()


def cross_entropy_one_hot(logits: torch.Tensor, target_oh: torch.Tensor,
                          weight: Optional[torch.Tensor] = None, reduction: str = "mean",
                          sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Soft-target cross entropy with optional per-class weights
    (reference ``Cross_entropy_one_hot``):
    ``loss_i = (sum_c w_c t_ic) * sum_c (-t_ic * log_softmax(o)_ic)``,
    reduced by mean or sum; ``sample_mask`` zeroes padded rows (masked
    mean)."""
    per = torch.sum(-target_oh * F.log_softmax(logits, dim=1), dim=1)
    if weight is not None:
        per = per * torch.sum(weight * target_oh, dim=1)
    if sample_mask is not None:
        per = per * sample_mask
        if reduction == "mean":
            return torch.sum(per) / torch.clamp(torch.sum(sample_mask), min=1.0)
        return torch.sum(per)
    if reduction == "mean":
        return torch.mean(per)
    if reduction == "sum":
        return torch.sum(per)
    raise NotImplementedError("reduction method unknown")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weight: Optional[torch.Tensor] = None,
                  sample_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hard-label cross entropy with torch ``CrossEntropyLoss``'s weighted
    mean (normalised by the summed weights of the targets)."""
    labels = labels.long()
    per = -torch.gather(F.log_softmax(logits, dim=1), 1, labels[:, None])[:, 0]
    w = weight[labels] if weight is not None else torch.ones_like(per)
    if sample_mask is not None:
        w = w * sample_mask
    return torch.sum(per * w) / torch.clamp(torch.sum(w), min=1e-12)


def mixup_with(x: torch.Tensor, y_oh: torch.Tensor, lam: torch.Tensor,
               perm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lam * x + (1 - lam) * x[perm]``, and the same for the targets."""
    return lam * x + (1.0 - lam) * x[perm], lam * y_oh + (1.0 - lam) * y_oh[perm]


def mixup(gen: torch.Generator, x: torch.Tensor, y_oh: torch.Tensor,
          lam: Optional[float] = None, prob: float = 1.0):
    """Permutation MixUp (reference ``MixUp``): with probability ``prob``
    per batch, λ ~ U(0, 1) (or the fixed ``lam``) and a random partner for
    every sample; otherwise λ = 1. Draws stay on the device."""
    dev = x.device
    apply = torch.rand((), generator=gen, device=dev) < prob
    if lam is None:
        lam_t = torch.rand((), generator=gen, device=dev)
    else:
        lam_t = torch.tensor(lam, dtype=torch.float32, device=dev)
    lam_t = torch.where(apply, lam_t, torch.ones((), device=dev))
    perm = torch.randperm(x.shape[0], generator=gen, device=dev)
    return mixup_with(x, y_oh, lam_t, perm)


def calc_class_weights(labels: np.ndarray, num_classes: int) -> np.ndarray:
    """Normalised inverse-frequency weights (reference
    ``calc_class_weights``); ones, with a warning, when no labels are
    present."""
    occ = np.bincount(np.asarray(labels, np.int64), minlength=num_classes).astype(np.float64)
    if occ.sum() == 0:
        warnings.warn("class weights could not be calculated - no weights are used")
        return np.ones(num_classes, np.float32)
    with np.errstate(divide="ignore"):
        cw = 1.0 / occ
    cw[~np.isfinite(cw)] = 0.0
    cw /= cw.sum()
    return cw.astype(np.float32)
