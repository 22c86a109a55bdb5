"""The PriMIA augmentation chain as one batched device function.

Port of ``primia_tpu/ops/augment.py``. The reference
(``torchlib/dataloader.py:138-217``) runs torchvision RandomAffine and an
albumentations chain per image on the CPU; here, as in the JAX package,
every transform is a batched tensor op on the device: each stochastic
transform draws its parameters for the whole batch and is gated per
sample with ``torch.where`` (both branches compute). The elastic,
optical and grid distortions are fused into one dense warp by summing
their displacement fields.

Order: the uint8 vertical flip (hoisted to the input, as in the JAX
chain), RandomAffine (two-pass K1 when ``twopass_safe`` holds for the
config's ranges, else K2), RandomCrop, CLAHE (K3), the gated block
(gamma, brightness, blur, the fused warp, grid shuffle, HSV, invert,
cutout, shadow, fog, sun flare, solarize, equalize, grid dropout),
GaussNoise, Normalize.

Draws come from one ``torch.Generator`` on the batch's device, in the
order of the chain; the JAX package draws from split PRNG keys, so the
two agree in distribution, not in pixels. Each draw is kept apart from
the math that uses it (``_affine_mats_from``, ``_coarse_field_from``), so
tests hand both packages the same numbers. The pixel pipeline is float32
on every device (the TPU runs it in bf16). GaussNoise stays plain
PyTorch (``randn``, clip, blend), as the JAX chain keeps it in
``jax.random.normal``.

Input: (B, R, R, C) uint8 NHWC at ``inference_resolution``. Output:
(B, C, Rt, Rt) float32 at ``train_resolution``, normalised, in NCHW
(``channels_last`` in memory), the model's layout; the JAX chain returns
NHWC.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from primia_tpu_torch.ops import image as I
from primia_tpu_torch.ops.numerics import div


class AugmentConfig(NamedTuple):
    # geometry (torchvision RandomAffine)
    rotation: float = 0.0
    translate: float = 0.0
    scale: float = 0.0
    shear: float = 0.0
    # albumentations block
    train_resolution: int = 224
    inference_resolution: int = 224
    clahe: bool = False
    overall_prob: float = 1.0
    individual_prob: float = 1.0
    noise_std: float = 0.0
    noise_prob: float = 0.0
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

    @classmethod
    def from_args(cls, args) -> "AugmentConfig":
        return cls(
            rotation=args.rotation, translate=args.translate, scale=args.scale,
            shear=args.shear, train_resolution=args.train_resolution,
            inference_resolution=args.inference_resolution, clahe=args.clahe,
            overall_prob=args.albu_prob, individual_prob=args.individual_albu_probs,
            noise_std=args.noise_std, noise_prob=args.noise_prob,
            randomgamma=args.randomgamma, randombrightness=args.randombrightness,
            blur=args.blur, elastic=args.elastic,
            optical_distortion=args.optical_distortion,
            grid_distortion=args.grid_distortion, grid_shuffle=args.grid_shuffle,
            hsv=args.hsv, invert=args.invert, cutout=args.cutout,
            shadow=args.shadow, fog=args.fog, sun_flare=args.sun_flare,
            solarize=args.solarize, equalize=args.equalize,
            grid_dropout=args.grid_dropout,
        )


# ----------------------------------------------------------------- draws

def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    return lo + (hi - lo) * u


def _randint(gen: torch.Generator, shape, lo: int, hi: int) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def _gate(gen: torch.Generator, p: float, B: int) -> torch.Tensor:
    return torch.rand(B, generator=gen, device=gen.device) < p


def _blend(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Per-sample select: mask (B,), tensors (B, C, H, W)."""
    return torch.where(mask[:, None, None, None], new, old)


# -------------------------------------------------------------- geometry

def _affine_mats_from(deg: torch.Tensor, t: torch.Tensor, s: torch.Tensor,
                      shear_deg: torch.Tensor, R: int) -> torch.Tensor:
    """Inverse affine matrices (B, 2, 3) of A = R(theta) Shear_x(shear) s*Id
    with a translation of ``t * R`` pixels: rotation ``deg`` and shear
    ``shear_deg`` in degrees, scale ``s``, all (B,) (``t`` (B, 2))."""
    theta = deg * (math.pi / 180.0)
    shear = shear_deg * (math.pi / 180.0)
    cos, sin = torch.cos(theta), torch.sin(theta)
    tan = torch.tan(shear)
    a = cos * s
    b = (cos * tan - sin) * s
    c = sin * s
    d = (sin * tan + cos) * s
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    tx, ty = t[:, 0] * R, t[:, 1] * R
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    return torch.stack(
        [torch.stack([ia, ib, itx], -1), torch.stack([ic, id_, ity], -1)], dim=1)


def _affine_mats(gen: torch.Generator, cfg: AugmentConfig, B: int) -> torch.Tensor:
    """Draws torchvision RandomAffine's ranges for B images."""
    deg = _uniform(gen, (B,), -cfg.rotation, cfg.rotation)
    t = _uniform(gen, (B, 2), -cfg.translate, cfg.translate)
    s = _uniform(gen, (B,), 1.0 - cfg.scale, 1.0 + cfg.scale)
    shear = _uniform(gen, (B,), -cfg.shear, cfg.shear)
    return _affine_mats_from(deg, t, s, shear, cfg.inference_resolution)


def _upsample_matrix(n_out: int, n_in: int, device=None) -> torch.Tensor:
    """(n_out, n_in) bilinear interpolation weights, half-pixel centres,
    rows renormalised at the edges (``jax.image.resize`` bilinear)."""
    scale = n_in / n_out
    pos = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * scale - 0.5
    idx = torch.arange(n_in, dtype=torch.float32, device=device)
    w = (1.0 - (pos[:, None] - idx[None, :]).abs()).clamp(0.0, 1.0)
    return w / w.sum(dim=1, keepdim=True)


def _coarse_field_from(f: torch.Tensor, H: int, W: int,
                       amp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smooth displacement fields (dy, dx), each (B, H, W), from coarse
    draws ``f`` (B, 2, c, c) in [-1, 1]: separable bilinear upsampling,
    scaled by ``amp`` (B,) pixels."""
    wh = _upsample_matrix(H, f.shape[-2], f.device)
    ww = _upsample_matrix(W, f.shape[-1], f.device)
    up = torch.einsum("hi,bcij,wj->bchw", wh, f, ww)
    return up[:, 0] * amp[:, None, None], up[:, 1] * amp[:, None, None]


def _coarse_field(gen: torch.Generator, B: int, H: int, W: int, coarse: int,
                  amp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    f = _uniform(gen, (B, 2, coarse, coarse), -1.0, 1.0)
    return _coarse_field_from(f, H, W, amp)


# ------------------------------------------------------------------- HSV

def _hsv_impl(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """RGB -> HSV, all in [0, 1], channels on ``axis``."""
    r, g, b = (x.select(axis, i) for i in range(3))
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    d = mx - mn + 1e-12
    h = torch.where(
        mx == r, torch.remainder((g - b) / d, 6.0),
        torch.where(mx == g, (b - r) / d + 2.0, (r - g) / d + 4.0)) / 6.0
    s = d / (mx + 1e-12)
    return torch.stack([h, s, mx], dim=axis)


def _hsv_to_rgb(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    h, s, v = x.select(axis, 0) * 6.0, x.select(axis, 1), x.select(axis, 2)
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(choices):
        out = choices[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, choices[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=axis)


# ------------------------------------------------------------------ chain

def build_augment_fn(cfg: AugmentConfig, mean, std, channels: int,
                     device="cpu") -> Callable[..., torch.Tensor]:
    """Returns ``augment(gen, u8_batch, global_batch=None, offset=0) ->
    float32 batch``.

    ``u8_batch``: (B, inference_res, inference_res, C) uint8 on
    ``device``; ``gen`` a ``torch.Generator`` on the same device. Output:
    (B, C, train_res, train_res) float32, normalised, ``channels_last``.

    ``global_batch``: ``u8_batch`` is rows ``offset ... offset + B - 1``
    of a batch of ``global_batch`` (one rank's shard in
    ``parallel/data_parallel.py``). Every draw is made for the whole batch
    and cut to these rows, so each row comes out as it would from the
    whole batch's call with the same generator.
    """
    device = torch.device(device)
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=device).reshape(1, channels, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=device).reshape(1, channels, 1, 1)
    R = cfg.inference_resolution
    Rt = cfg.train_resolution

    def augment(gen: torch.Generator, batch_u8: torch.Tensor, global_batch=None,
                offset: int = 0) -> torch.Tensor:
        B = batch_u8.shape[0]
        Bd = B if global_batch is None else global_batch  # the draws' batch
        dev = batch_u8.device

        def mine(t: torch.Tensor) -> torch.Tensor:
            return t if Bd == B else t[offset:offset + B]

        p = cfg.individual_prob
        # the block gate comes first: the JAX chain draws the flip's block
        # gate from the same key as the block's, so the flip is gated by it
        block_on = mine(_gate(gen, cfg.overall_prob, Bd))
        # vertical flip, hoisted to the uint8 input (exactly distribution-
        # preserving; see the JAX chain's note)
        flip_m = mine(_gate(gen, p, Bd)) & block_on
        batch_u8 = torch.where(flip_m[:, None, None, None], batch_u8.flip(1), batch_u8)
        x = div(batch_u8.permute(0, 3, 1, 2).float(), 255.0)

        # 1. RandomAffine: the two-pass shear warp (K1) when the config's
        # matrix ranges are well-conditioned, else the bilinear gather (K2)
        if cfg.rotation or cfg.translate or cfg.scale or cfg.shear:
            mats = mine(_affine_mats(gen, cfg, Bd))
            safe = I.twopass_safe(cfg.rotation, cfg.shear, cfg.scale)
            x = I.warp_affine(x, mats, twopass=safe, channels_first=True)

        # 2. RandomCrop(train_resolution) after the host-side Resize
        if Rt < R:
            off = mine(_randint(gen, (Bd, 2), 0, R - Rt + 1))
            ar = torch.arange(Rt, device=dev)
            C = x.shape[1]
            rows = (off[:, 0, None] + ar)[:, None, :, None].expand(B, C, Rt, R)
            x = torch.gather(x, 2, rows)
            cols = (off[:, 1, None] + ar)[:, None, None, :].expand(B, C, Rt, Rt)
            x = torch.gather(x, 3, cols)

        # 3. CLAHE (always applied when enabled; clip_limit=(1,1) in the ref)
        if cfg.clahe:
            x = I.clahe(x, clip_limit=1.0, tiles=8, channels_first=True)

        # 4. the gated albumentations block
        def gated(fn):
            nonlocal x
            m = mine(_gate(gen, p, Bd)) & block_on
            x = _blend(m, fn(), x)

        if cfg.randomgamma:
            def gamma_fn():
                g = mine(_uniform(gen, (Bd, 1, 1, 1), 0.8, 1.2))
                return torch.pow(x.clamp(min=1e-6), g)
            gated(gamma_fn)

        if cfg.randombrightness:
            def bright_fn():
                f = mine(_uniform(gen, (Bd, 1, 1, 1), -0.2, 0.2))
                return (x + f).clamp(0.0, 1.0)
            gated(bright_fn)

        if cfg.blur:
            gated(lambda: I.box_blur(x, 3, channels_first=True))

        # fused geometric distortions: sum the displacement fields, warp once
        max_disp = 0.0  # static |dy| bound, moot for the gather
        fields = []
        if cfg.elastic:
            fields.append(("coarse", Rt // 8, 2.0))
            max_disp += 2.0
        if cfg.optical_distortion:
            fields.append(("radial", None, None))
            # |dy| = |k| r^2 |ys| / (cy cx) <= 0.05 * 2 * (Rt-1)/2
            max_disp += 0.05 * (Rt - 1)
        if cfg.grid_distortion:
            fields.append(("coarse", 6, 0.06 * Rt))
            max_disp += 0.06 * Rt
        if fields:
            dy = torch.zeros((B, Rt, Rt), dtype=torch.float32, device=dev)
            dx = torch.zeros((B, Rt, Rt), dtype=torch.float32, device=dev)
            for kind, coarse, amp_max in fields:
                m = (mine(_gate(gen, p, Bd)) & block_on).float()
                if kind == "coarse":
                    amp = mine(_uniform(gen, (Bd,), 0.0, amp_max)) * m
                    f = mine(_uniform(gen, (Bd, 2, coarse, coarse), -1.0, 1.0))
                    fy, fx = _coarse_field_from(f, Rt, Rt, amp)
                    dy, dx = dy + fy, dx + fx
                else:
                    # barrel/pincushion: r' = r (1 + k r^2), k ~ U(-.05, .05)
                    kk = mine(_uniform(gen, (Bd, 1, 1), -0.05, 0.05)) * m[:, None, None]
                    cy = cx = (Rt - 1) / 2.0
                    rr, cc = I.pixel_grid(Rt, Rt, dev)
                    ys, xs = rr - cy, cc - cx
                    r2 = div(ys ** 2 + xs ** 2, cy * cx)
                    dy = dy + kk * r2 * ys
                    dx = dx + kk * r2 * xs
            x = I.warp_dense(x, dy, dx, max_dy=max_disp, channels_first=True)

        if cfg.grid_shuffle:
            def shuffle_fn():
                g = 3
                cell = Rt // g
                C = x.shape[1]
                cells = x[:, :, : g * cell, : g * cell].reshape(B, C, g, cell, g, cell)
                cells = cells.permute(0, 2, 4, 1, 3, 5).reshape(B, g * g, C, cell, cell)
                perm = torch.argsort(mine(torch.rand((Bd, g * g), generator=gen, device=dev)),
                                     dim=1)
                cells = cells[torch.arange(B, device=dev)[:, None], perm]
                out = cells.reshape(B, g, g, C, cell, cell).permute(0, 3, 1, 4, 2, 5)
                out = out.reshape(B, C, g * cell, g * cell)
                if g * cell < Rt:
                    out = torch.nn.functional.pad(out, (0, Rt - g * cell, 0, Rt - g * cell))
                return out
            gated(shuffle_fn)

        if cfg.hsv and channels == 3:
            def hsv_fn():
                sh = mine(_uniform(gen, (Bd, 3), -1.0, 1.0)) * torch.tensor(
                    [20 / 255.0, 30 / 255.0, 20 / 255.0], device=dev)
                h, s, v = _hsv_impl(x, axis=1).unbind(1)
                hsv = torch.stack(
                    [torch.remainder(h + sh[:, 0, None, None], 1.0),
                     (s + sh[:, 1, None, None]).clamp(0, 1),
                     (v + sh[:, 2, None, None]).clamp(0, 1)], dim=1)
                return _hsv_to_rgb(hsv, axis=1)
            gated(hsv_fn)

        if cfg.invert:
            gated(lambda: 1.0 - x)

        if cfg.cutout:
            def cutout_fn():
                mask = torch.ones((B, 1, Rt, Rt), dtype=torch.float32, device=dev)
                rr, cc = I.pixel_grid(Rt, Rt, dev)
                for _ in range(5):  # 5 holes up to 80x80 (ref dataloader.py:180)
                    c = mine(_randint(gen, (Bd, 2), 0, Rt)).float()
                    wh = mine(_randint(gen, (Bd, 2), 1, min(80, Rt) + 1)).float()
                    inside = ((rr >= c[:, 0, None, None]) & (rr < (c[:, 0] + wh[:, 0])[:, None, None])
                              & (cc >= c[:, 1, None, None])
                              & (cc < (c[:, 1] + wh[:, 1])[:, None, None]))
                    mask = mask * (1.0 - inside[:, None].float())
                return x * mask
            gated(cutout_fn)

        if cfg.shadow:
            def shadow_fn():
                # darken a random vertical band (simplified RandomShadow)
                a = mine(_randint(gen, (Bd, 1, 1, 1), 0, Rt))
                w = mine(_randint(gen, (Bd, 1, 1, 1), Rt // 8, Rt // 2))
                xs = torch.arange(Rt, device=dev).reshape(1, 1, 1, Rt)
                band = (xs >= a) & (xs < a + w)
                return torch.where(band, x * 0.5, x)
            gated(shadow_fn)

        if cfg.fog:
            def fog_fn():
                f = mine(_uniform(gen, (Bd, 1, 1, 1), 0.1, 0.45))
                return I.box_blur(x * (1 - f) + f, 3, channels_first=True)
            gated(fog_fn)

        if cfg.sun_flare:
            def flare_fn():
                c = mine(_uniform(gen, (Bd, 2), 0.0, float(Rt)))
                rad = mine(_uniform(gen, (Bd,), Rt / 8, Rt / 3))
                rr, cc = I.pixel_grid(Rt, Rt, dev)
                d2 = (rr[None] - c[:, 0, None, None]) ** 2 + (cc[None] - c[:, 1, None, None]) ** 2
                glow = torch.exp(-d2 / (2 * (rad[:, None, None] / 2) ** 2))
                return (x + glow[:, None]).clamp(0, 1)
            gated(flare_fn)

        if cfg.solarize:
            gated(lambda: torch.where(x >= 0.5, 1.0 - x, x))

        if cfg.equalize:
            gated(lambda: I.equalize(x, channels_first=True))

        if cfg.grid_dropout:
            def gd_fn():
                cell = Rt // 8
                ar = torch.arange(Rt, device=dev) // cell
                keep = ((ar[:, None] + ar[None, :]) % 2 == 0)
                return x * keep
            gated(gd_fn)

        # 5. GaussNoise(var_limit=noise_std^2, p=noise_prob)
        if cfg.noise_std > 0 and cfg.noise_prob > 0:
            m = mine(_gate(gen, cfg.noise_prob, Bd))
            # the dense field is drawn for the whole batch too
            noise = mine(torch.randn((Bd, *x.shape[1:]), generator=gen, device=dev))
            noise = noise * cfg.noise_std
            x = _blend(m, (x + noise).clamp(0.0, 1.0), x)

        # 6. Normalize (images already in [0, 1] = ToFloat(255))
        x = (x - mean_t) / std_t
        return x.contiguous(memory_format=torch.channels_last)

    return augment


def normalize_only(batch_u8: torch.Tensor, mean, std, channels: int) -> torch.Tensor:
    """The eval-time transform, ToFloat + Normalize, on (B, R, R, C)
    uint8; returns (B, C, R, R) float32 (``channels_last``)."""
    dev = batch_u8.device
    mean_t = torch.as_tensor(np.asarray(mean, np.float32), device=dev).reshape(1, channels, 1, 1)
    std_t = torch.as_tensor(np.asarray(std, np.float32), device=dev).reshape(1, channels, 1, 1)
    x = div(batch_u8.permute(0, 3, 1, 2).float(), 255.0)
    return ((x - mean_t) / std_t).contiguous(memory_format=torch.channels_last)
