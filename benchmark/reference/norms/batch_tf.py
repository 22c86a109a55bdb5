"""Batch norm with eps 1e-3, TensorFlow's default, which MaxViT's authors'
release keeps: otherwise ``batch.py``'s, batch statistics in train mode,
running statistics in eval mode; in train mode with ``settle`` the running
statistics in ``B`` become the batch's (in place)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-3


def apply(x, W, B, name, train, settle=False):
    if train:
        rm, rv = B[name + ".running_mean"], B[name + ".running_var"]
        if not settle:
            rm, rv = rm.clone(), rv.clone()
        return F.batch_norm(x, rm, rv, W[name + ".weight"], W[name + ".bias"], training=True,
                            momentum=1.0 if settle else 0.1, eps=EPS)
    inv = W[name + ".weight"] * torch.rsqrt(B[name + ".running_var"] + EPS)
    off = W[name + ".bias"] - B[name + ".running_mean"] * inv
    return x * inv.reshape(1, -1, 1, 1) + off.reshape(1, -1, 1, 1)
