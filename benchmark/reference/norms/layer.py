"""Layer norm over the last dimension (eps 1e-5), the same in train and eval
mode: no running statistics."""

from __future__ import annotations

import torch.nn.functional as F


def apply(x, W, B, name, train, settle=False):
    return F.layer_norm(x, (x.shape[-1],), W[name + ".weight"], W[name + ".bias"], 1e-5)
