"""Plain train steps: augmentation, MixUp, forward and backward, soft-target
cross entropy and Adam with an L2 term, in float32.

``steps`` replays the first steps of a run from the weights and batches
the benchmark made, with a generator seeded as the one the program was
handed, and returns what the comparison reads: each step's loss, the
first step's gradient as the optimizer takes it (with the L2 term), and
the parameters after the last step.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import augment as A
from benchmark.reference.models import forward


def steps(weights: Dict[str, torch.Tensor], buffers: Dict[str, torch.Tensor],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], gen_seed: int, cfg: dict,
          mean: torch.Tensor, std: torch.Tensor, precision: str = "float32",
          half_batch: bool = False) -> dict:
    """``batches``: (uint8 images, int labels) on one device. ``half_batch``
    takes the loss over the first half of each batch only (a fault the
    comparison has to reject)."""
    a, arch = cfg["args"], cfg["architecture"]
    dev = batches[0][0].device
    names = list(weights)
    P = {n: weights[n].detach().clone().float().requires_grad_(True) for n in names}
    Bf = {n: t.detach().clone() for n, t in buffers.items()}
    mu = {n: torch.zeros_like(P[n]) for n in names}
    nu = {n: torch.zeros_like(P[n]) for n in names}
    b1, b2, eps, wd, lr = a["beta1"], a["beta2"], cfg["adam_eps"], a["weight_decay"], a["lr"]
    gen = torch.Generator(device=dev).manual_seed(gen_seed)
    losses: List[float] = []
    first = None
    for t, (u8, labels) in enumerate(batches, 1):
        x = A.augment(gen, u8, a, mean, std)
        y = F.one_hot(labels.long(), arch["num_classes"]).float()
        if a["mixup"]:
            x, y = A.mixup(gen, x, y, a["mixup_prob"])
        taps = {}
        logits = forward(P, Bf, x, arch, train=True, precision=precision, taps=taps).float()
        per = torch.sum(-y * F.log_softmax(logits, dim=1), dim=1)
        if half_batch:
            per = per[: per.shape[0] // 2]
        loss = per.mean()
        *grads, d_logits = torch.autograd.grad(loss, [P[n] for n in names] + [logits])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {n: gr + wd * P[n] for n, gr in zip(names, grads)}
            if first is None:
                first = {n: v.clone() for n, v in g.items()}
                raw = {n: float(gr.double().norm()) for n, gr in zip(names, grads)}
                # the output layer's weight gradient is a sum over the batch
                # of d_logits h^T; the norm of its terms' magnitudes
                h = taps["head_input"].detach()
                terms = float((d_logits.abs().double().t() @ h.abs().double()).norm())
            bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
            for n in names:
                mu[n].mul_(b1).add_(g[n], alpha=1.0 - b1)
                nu[n].mul_(b2).addcmul_(g[n], g[n], value=1.0 - b2)
                P[n].sub_(lr * (mu[n] / bc1) / ((nu[n] / bc2).sqrt() + eps))
    return {"losses": losses, "first_grad": first, "loss_grad_norms": raw, "head_terms": terms,
            "params": {n: p.detach() for n, p in P.items()}}
