"""Plain augmentation chain and MixUp of PriMIA's train step.

The recipe's semantics (torchvision RandomAffine, albumentations' block
gated as a whole and per transform, GaussNoise, Normalize, permutation
MixUp) with the draw protocol the program documents for its train step:
every draw comes from the one ``torch.Generator`` handed to the step, for
the whole batch, in the order of the chain, each gate before the draws of
its transform. So the reference, given a generator seeded alike, draws
the same numbers; what it does with them is its own plain arithmetic.

Transforms outside the benchmark's configurations (a random crop, the
joint bilinear affine warp, the albumentations transforms the recipes
leave off) raise.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import image as I

_UNSUPPORTED = ("grid_shuffle", "hsv", "invert", "cutout", "shadow", "sun_flare", "solarize",
                "equalize", "grid_dropout")


def _uniform(gen, shape, lo, hi):
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _gate(gen, p, B):
    return torch.rand(B, generator=gen, device=gen.device) < p


def _blend(mask, new, old):
    return torch.where(mask[:, None, None, None], new, old)


def _affine_inverse(deg, t, s, shear_deg, R):
    """Inverse maps (B, 2, 3) of R(deg) Shear_x(shear) s with a translation
    of t * R pixels."""
    theta = deg * (math.pi / 180.0)
    shear = shear_deg * (math.pi / 180.0)
    cos, sin, tan = torch.cos(theta), torch.sin(theta), torch.tan(shear)
    a, b = cos * s, (cos * tan - sin) * s
    c, d = sin * s, (sin * tan + cos) * s
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    tx, ty = t[:, 0] * R, t[:, 1] * R
    itx, ity = -(ia * tx + ib * ty), -(ic * tx + id_ * ty)
    return torch.stack([torch.stack([ia, ib, itx], -1), torch.stack([ic, id_, ity], -1)], 1)


def _upsample(n_out: int, n_in: int, device) -> torch.Tensor:
    """Bilinear weights (n_out, n_in), half-pixel centres, rows summing to 1."""
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * (n_in / n_out) - 0.5
    idx = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (pos[:, None] - idx[None, :]).abs()).clamp(0.0, 1.0)
    return w / w.sum(dim=1, keepdim=True)


def augment(gen: torch.Generator, u8: torch.Tensor, a: dict, mean: torch.Tensor,
            std: torch.Tensor) -> torch.Tensor:
    """(B, R, R, C) uint8 -> (B, C, Rt, Rt) float32, normalised; ``a`` is the
    configuration's recipe (its ``args``)."""
    for k in _UNSUPPORTED:
        if a.get(k):
            raise NotImplementedError(f"the reference chain has no {k}")
    B, R = u8.shape[0], u8.shape[1]
    Rt = a["train_resolution"]
    if Rt != R or not I.twopass_safe(a["rotation"], a["shear"], a["scale"]):
        raise NotImplementedError("the reference chain has no random crop and only the "
                                  "two-pass affine warp")
    dev = u8.device
    p = a["individual_albu_probs"]
    block = _gate(gen, a["albu_prob"], B)
    flip = _gate(gen, p, B) & block
    u8 = torch.where(flip[:, None, None, None], u8.flip(1), u8)
    x = I.div(u8.permute(0, 3, 1, 2).float(), 255.0)

    if a["rotation"] or a["translate"] or a["scale"] or a["shear"]:
        deg = _uniform(gen, (B,), -a["rotation"], a["rotation"])
        t = _uniform(gen, (B, 2), -a["translate"], a["translate"])
        s = _uniform(gen, (B,), 1.0 - a["scale"], 1.0 + a["scale"])
        sh = _uniform(gen, (B,), -a["shear"], a["shear"])
        x = I.warp_affine(x, _affine_inverse(deg, t, s, sh, R))

    if a["clahe"]:
        x = I.clahe(x, 1.0, 8)

    def gated(fn):
        nonlocal x
        m = _gate(gen, p, B) & block
        x = _blend(m, fn(), x)

    if a["randomgamma"]:
        gated(lambda: torch.pow(x.clamp(min=1e-6), _uniform(gen, (B, 1, 1, 1), 0.8, 1.2)))
    if a["randombrightness"]:
        gated(lambda: (x + _uniform(gen, (B, 1, 1, 1), -0.2, 0.2)).clamp(0.0, 1.0))
    if a["blur"]:
        gated(lambda: I.box_blur(x, 3))

    fields = []
    if a["elastic"]:
        fields.append(("coarse", Rt // 8, 2.0))
    if a["optical_distortion"]:
        fields.append(("radial", None, None))
    if a["grid_distortion"]:
        fields.append(("coarse", 6, 0.06 * Rt))
    if fields:
        dy = torch.zeros((B, Rt, Rt), dtype=torch.float32, device=dev)
        dx = torch.zeros_like(dy)
        for kind, coarse, amp_max in fields:
            m = (_gate(gen, p, B) & block).float()
            if kind == "coarse":
                amp = _uniform(gen, (B,), 0.0, amp_max) * m
                f = _uniform(gen, (B, 2, coarse, coarse), -1.0, 1.0)
                w = _upsample(Rt, coarse, dev)
                up = torch.einsum("hi,bcij,wj->bchw", w, f, w)
                dy = dy + up[:, 0] * amp[:, None, None]
                dx = dx + up[:, 1] * amp[:, None, None]
            else:
                k = _uniform(gen, (B, 1, 1), -0.05, 0.05) * m[:, None, None]
                c = (Rt - 1) / 2.0
                rr, cc = I.pixel_grid(Rt, Rt, dev)
                ys, xs = rr - c, cc - c
                r2 = I.div(ys ** 2 + xs ** 2, c * c)
                dy = dy + k * r2 * ys
                dx = dx + k * r2 * xs
        x = I.warp_dense(x, dy, dx)

    if a["fog"]:
        def fog():
            f = _uniform(gen, (B, 1, 1, 1), 0.1, 0.45)
            return I.box_blur(x * (1 - f) + f, 3)
        gated(fog)

    if a["noise_std"] > 0 and a["noise_prob"] > 0:
        m = _gate(gen, a["noise_prob"], B)
        noise = torch.randn((B, *x.shape[1:]), generator=gen, device=dev) * a["noise_std"]
        x = _blend(m, (x + noise).clamp(0.0, 1.0), x)

    return (x - mean.reshape(1, -1, 1, 1)) / std.reshape(1, -1, 1, 1)


def mixup(gen: torch.Generator, x: torch.Tensor, y: torch.Tensor, prob: float):
    """Permutation MixUp: with probability ``prob`` a batch mixes each
    sample with a random partner under one λ ~ U(0, 1), else λ = 1."""
    dev = gen.device
    apply = torch.rand((), generator=gen, device=dev) < prob
    lam = torch.rand((), generator=gen, device=dev)
    lam = torch.where(apply, lam, torch.ones((), device=dev))
    perm = torch.randperm(x.shape[0], generator=gen, device=dev)
    return lam * x + (1.0 - lam) * x[perm], lam * y + (1.0 - lam) * y[perm]
