"""The Gaussian-noise kernel of the augmentation (K5).

Port of ``primia_tpu/ops/pallas_kernels.py``.

- :func:`add_gaussian_noise` is K5, in ``primia_tpu_torch/csrc/noise.cu``
  (its header note names the TPU kernel, ``_noise_kernel``, and states
  the bound): x + sigma * N(0, 1) with one stream per batch row, from a
  Philox-4x32-10 written in the kernel, key (seed, row), one block for
  four consecutive elements of a row (counter (g mod 2^32, g >> 32, 0, 0)
  for group g = j >> 2), so no noise tensor is stored. The block's words
  (w0, w1) are pair 2g and (w2, w3) pair 2g + 1; pair p gives element 2p
  the cosine branch of Box-Muller and element 2p + 1 the sine branch of
  the same (u1, u2). The TPU kernel draws two words for every element and
  keeps only the cosine branch: the port deviates on purpose, with the
  same N(0, 1) for each element and independent elements.
  :func:`add_gaussian_noise_plain` computes the same Philox words with
  32-bit words held in int64, as ``mpc/prg.py`` does for Threefry. The
  TPU's hardware bits cannot be reproduced, so the JAX package and the
  port agree in distribution, not in values. Neither package wires it
  into the augmentation chain (the JAX chain draws its GaussNoise from
  ``jax.random.normal``).
- The file's other TPU kernel, K6 (``resample_bilinear_pallas``,
  bilinear with zero fill), has no module of its own: its contract is
  ``ops/image.py:warp_affine(twopass=False)`` on K2's kernel
  (``ops/cuda_tent.py:tent_bilinear``), in float32 where the TPU kernel
  rounds the image to bf16 for its matmuls.

A wrapper given a CPU tensor runs the plain version; given a CUDA tensor
it launches the kernel or raises. ``_build.launches`` counts K5's
launches, not those of its check, :func:`noise_uniforms`. The launch
follows :func:`plan_noise`: one wave of the blocks the card holds at
once, each thread walking (row, group) items in a grid stride.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from primia_tpu_torch.ops._build import declare, launch, on_card, query, sm_count

_vp, _ci, _cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
declare("noise", {"gaussian_noise": [_vp, _vp, _cu, _cu, _ci, _cu, ctypes.c_float, _cu, _cu, _cu,
                                     _cu],
                  "gaussian_noise_uniforms": [_vp, _cu, _cu, _cu, _cu, _cu, _cu, _cu]},
        uncounted=("gaussian_noise_uniforms",),
        queries={"gaussian_noise_blocks_per_sm": [_ci, _ci]})

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
NOISE_THREADS = 256  # csrc/noise.cu's block


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * a`` for 32-bit words in int64:
    ``a`` is split in 16-bit halves so no product leaves int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox_words_plain(rows: int, groups: int, seed: int, device) -> Tuple[torch.Tensor, ...]:
    """The four words of Philox-4x32-10 with key (seed, row) at counter
    (g mod 2^32, g >> 32, 0, 0), for each row and group g < groups (the
    elements 4g .. 4g + 3 of the row): four (rows, groups) int64 tensors
    of 32-bit words."""
    g = torch.arange(groups, dtype=torch.int64, device=device).expand(rows, groups)
    c0, c1 = g & _MASK, g >> 32
    c2 = c3 = torch.zeros_like(c0)
    k0 = seed & _MASK
    k1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _pair_uniforms(rows: int, n: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, u2), float32 (rows, ceil(n / 2)), of each pair p: the top 24
    bits of its two words over 2^24, u1 + 1e-7
    (``pallas_kernels.py:_noise_kernel``)."""
    groups = -(-n // 4)
    w = torch.stack(philox_words_plain(rows, groups, seed, device), -1)
    w = w.reshape(rows, 2 * groups, 2)[:, :-(-n // 2)]  # pair 2g: (w0, w1), 2g + 1: (w2, w3)
    scale = torch.tensor(2.0 ** -24, dtype=torch.float32, device=device)
    u = (w >> 8).to(torch.float32) * scale
    return u[..., 0] + torch.tensor(1e-7, dtype=torch.float32, device=device), u[..., 1]


def noise_uniforms_plain(rows: int, n: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, u2), float32 (rows, n): each element's pair's uniforms, the
    same for elements 2p and 2p + 1."""
    return tuple(u.repeat_interleave(2, dim=1)[:, :n]
                 for u in _pair_uniforms(rows, n, seed, device))


def _check_noise(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() < 1 or x.shape[0] == 0 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, ...) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    return x.shape[0], x.numel() // x.shape[0]


def add_gaussian_noise_plain(x: torch.Tensor, seed: int, sigma: float) -> torch.Tensor:
    """:func:`add_gaussian_noise` in plain PyTorch."""
    B, n = _check_noise(x)
    u1, u2 = _pair_uniforms(B, n, seed, x.device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = f32(2.0 * math.pi) * u2
    nrm = torch.stack((r * torch.cos(theta), r * torch.sin(theta)), -1).reshape(B, -1)[:, :n]
    noise = (f32(sigma) * nrm).to(x.dtype)
    return (x.reshape(B, n) + noise).reshape(x.shape)


@dataclasses.dataclass(frozen=True)
class NoisePlan:
    """K5's launch: ``grid`` blocks of :data:`NOISE_THREADS` threads over
    rows * ``groups`` items (a row's groups of four elements, the last one
    ragged); the grid's threads make one stride of ``step_rows`` rows and
    ``step_groups`` groups."""
    grid: int
    groups: int
    step_rows: int
    step_groups: int


def plan_noise(rows: int, n: int, blocks_per_sm: int, sms: int) -> NoisePlan:
    """K5's plan for (rows, n): as many blocks as the card holds at once
    (``blocks_per_sm`` on each of ``sms``), one wave, and no more blocks
    than the items need."""
    groups = -(-n // 4)
    grid = max(1, min(-(-rows * groups // NOISE_THREADS), blocks_per_sm * sms))
    step_rows, step_groups = divmod(grid * NOISE_THREADS, groups)
    return NoisePlan(grid, groups, step_rows, step_groups)


@functools.lru_cache(maxsize=None)
def _blocks_per_sm(device_index: int, dtype: int, mode: int) -> int:
    return query("noise", "gaussian_noise_blocks_per_sm", torch.device("cuda", device_index),
                 dtype, mode)


def card_plan(device: torch.device, rows: int, n: int, dtype: int = 0,
              mode: int = 0) -> NoisePlan:
    """:func:`plan_noise` for the card ``device``: its SM count and the
    kernel's occupancy from the CUDA occupancy API (dtype 0 = float32,
    1 = bfloat16; mode 0 = noise, 1 = uniforms)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    return plan_noise(rows, n, _blocks_per_sm(index, dtype, mode), sm_count(device))


def _check_rows(x: torch.Tensor, n: int) -> None:
    if x.shape[0] > 65535:
        raise ValueError(f"K5 takes at most 65,535 rows, got {x.shape[0]}")
    if n >= 1 << 31:
        raise ValueError(f"K5 takes rows of fewer than 2^31 elements, got {n}")


def add_gaussian_noise(x: torch.Tensor, seed: int, sigma: float) -> torch.Tensor:
    """K5: ``x + sigma * N(0, 1)``, the normal draws by Box-Muller from the
    row's own Philox stream: ``pallas_kernels.py:add_gaussian_noise_pallas``.
    x: (B, ...) float32 or bfloat16; returns a new tensor of x's shape and
    dtype."""
    B, n = _check_noise(x)
    if not on_card(x, "K5"):
        return add_gaussian_noise_plain(x, seed, sigma)
    _check_rows(x, n)
    x = x.contiguous()
    out = torch.empty_like(x)
    dtype = _DTYPES[x.dtype]
    p = card_plan(x.device, B, n, dtype)
    launch("noise", "gaussian_noise", x.device, x.data_ptr(), out.data_ptr(), B, n, dtype,
           seed & _MASK, float(sigma), p.grid, p.groups, p.step_rows, p.step_groups)
    return out


def noise_uniforms(x: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (u1, u2) that :func:`add_gaussian_noise` draws for each element
    of ``x``, each (B, n) float32, from K5's own code on the card (the
    check against :func:`noise_uniforms_plain`; not a launch of K5's
    path)."""
    B, n = _check_noise(x)
    if not on_card(x, "K5"):
        return noise_uniforms_plain(B, n, seed, x.device)
    _check_rows(x, n)
    out = torch.empty((B, n, 2), dtype=torch.float32, device=x.device)
    p = card_plan(x.device, B, n, mode=1)
    launch("noise", "gaussian_noise_uniforms", x.device, out.data_ptr(), B, n, seed & _MASK,
           p.grid, p.groups, p.step_rows, p.step_groups)
    return out[..., 0], out[..., 1]
