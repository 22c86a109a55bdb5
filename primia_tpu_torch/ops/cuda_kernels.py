"""The Gaussian-noise kernel of the augmentation (K5).

Port of ``primia_tpu/ops/pallas_kernels.py``.

- :func:`add_gaussian_noise` is K5, in ``primia_tpu_torch/csrc/noise.cu``
  (its header note names the TPU kernel, ``_noise_kernel``, and states
  the bound): x + sigma * N(0, 1) with one stream per batch row, from a
  Philox-4x32-10 written in the kernel, key (seed, row) and counter
  (element index in the row, 0, 0, 0), so no noise tensor is stored.
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
it launches the kernel or raises. ``launches`` counts K5's launches, one
per wrapper call that reached the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

launches = {"gaussian_noise": 0}

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of ``m * a`` for 32-bit words in int64:
    ``a`` is split in 16-bit halves so no product leaves int64."""
    p_lo = (a & 0xFFFF) * m
    p_hi = (a >> 16) * m
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK


def philox_words_plain(rows: int, n: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first two words of Philox-4x32-10 with key (seed, row) at counter
    (j, 0, 0, 0), for each row and element j < n: two (rows, n) int64
    tensors of 32-bit words."""
    j = torch.arange(n, dtype=torch.int64, device=device).expand(rows, n)
    c0, c1 = j & _MASK, j >> 32
    c2 = c3 = torch.zeros_like(c0)
    k0 = seed & _MASK
    k1 = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1


def noise_uniforms_plain(rows: int, n: int, seed: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u1, u2), float32 (rows, n): the top 24 bits of each word over 2^24,
    u1 + 1e-7 (``pallas_kernels.py:_noise_kernel``)."""
    b1, b2 = philox_words_plain(rows, n, seed, device)
    scale = torch.tensor(2.0 ** -24, dtype=torch.float32, device=device)
    u1 = (b1 >> 8).to(torch.float32) * scale + torch.tensor(1e-7, dtype=torch.float32,
                                                            device=device)
    return u1, (b2 >> 8).to(torch.float32) * scale


def _check_noise(x: torch.Tensor) -> Tuple[int, int]:
    if x.dim() < 1 or x.shape[0] == 0 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, ...) tensor, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"K5 takes float32 or bfloat16, got {x.dtype}")
    return x.shape[0], x.numel() // x.shape[0]


def add_gaussian_noise_plain(x: torch.Tensor, seed: int, sigma: float) -> torch.Tensor:
    """:func:`add_gaussian_noise` in plain PyTorch."""
    B, n = _check_noise(x)
    u1, u2 = noise_uniforms_plain(B, n, seed, x.device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=x.device)  # noqa: E731
    r = torch.sqrt(-2.0 * torch.log(u1))
    nrm = r * torch.cos(f32(2.0 * math.pi) * u2)
    noise = (f32(sigma) * nrm).to(x.dtype)
    return (x.reshape(B, n) + noise).reshape(x.shape)


def _launch_noise(fn: str, *args) -> None:
    lib = _lib()
    err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} launch failed: CUDA error {err} "
                           f"({lib.noise_error_string(err).decode()})")


@functools.cache
def _lib():
    """``csrc/noise.cu``, built on first use, with its C signatures."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("noise")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.gaussian_noise.argtypes = [vp, vp, ci, ll, ci, ctypes.c_uint, ctypes.c_float, vp]
    lib.gaussian_noise.restype = ci
    lib.gaussian_noise_uniforms.argtypes = [vp, ci, ll, ctypes.c_uint, vp]
    lib.gaussian_noise_uniforms.restype = ci
    lib.noise_error_string.argtypes = [ci]
    lib.noise_error_string.restype = ctypes.c_char_p
    return lib


def _cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"K5 runs on CPU or CUDA tensors, not {x.device}")
    if x.shape[0] > 65535:
        raise ValueError(f"K5 takes at most 65,535 rows, got {x.shape[0]}")


def add_gaussian_noise(x: torch.Tensor, seed: int, sigma: float) -> torch.Tensor:
    """K5: ``x + sigma * N(0, 1)``, the normal draws by Box-Muller from the
    row's own Philox stream: ``pallas_kernels.py:add_gaussian_noise_pallas``.
    x: (B, ...) float32 or bfloat16; returns a new tensor of x's shape and
    dtype."""
    B, n = _check_noise(x)
    if x.device.type == "cpu":
        return add_gaussian_noise_plain(x, seed, sigma)
    _cuda(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch_noise("gaussian_noise", x.data_ptr(), out.data_ptr(), B, n, _DTYPES[x.dtype],
                      seed & _MASK, float(sigma), stream)
    launches["gaussian_noise"] += 1
    return out


def noise_uniforms(x: torch.Tensor, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (u1, u2) that :func:`add_gaussian_noise` draws for each element
    of ``x``, each (B, n) float32, from K5's own code on the card (the
    check against :func:`noise_uniforms_plain`; not a launch of K5's
    path)."""
    B, n = _check_noise(x)
    if x.device.type == "cpu":
        return noise_uniforms_plain(B, n, seed, x.device)
    _cuda(x)
    out = torch.empty((B, n, 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        _launch_noise("gaussian_noise_uniforms", out.data_ptr(), B, n, seed & _MASK, stream)
    return out[..., 0], out[..., 1]
