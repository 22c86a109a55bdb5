"""The FSS sign kernel K4: DCF key generation and both parties' evaluation
in one pass.

Port of ``primia_tpu/ops/pallas_dcf.py:dcf_sign_fused``. The CUDA kernel
lives in ``primia_tpu_torch/csrc/dcf.cu``; its header note names the TPU
kernel it replaces (``_sign_kernel``), states the bound (integer issue:
the rotations and xors of the Threefry blocks on the INT32 lanes, 12
blocks a level and 3 more past the level where x leaves alpha's path,
over 31 levels an element) and the design. This module holds the
wrapper and, in the same file, the plain PyTorch version: ``mpc/dcf.py``'s
``dcf_gen_from_seeds`` followed by ``dcf_eval`` at both parties.

Contract: ``dcf_sign(seeds, alpha, c, x)`` with 32-bit words in int32
tensors (read as unsigned) -- seeds (2, N, 4), alpha, c, x (N,), c in
{0, 1} -- returns (2, N) int64 shares with

    share[0] + share[1] == (1 - 2c) * 1{x < alpha}   (mod 2^64)

over ``n_bits``-bit points. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel or raises.
``launches`` counts the calls that reached the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from primia_tpu_torch.mpc.dcf import dcf_eval, dcf_gen_from_seeds
from primia_tpu_torch.mpc.prg import MASK32

launches = {"dcf_sign": 0}


def _check(seeds: torch.Tensor, alpha: torch.Tensor, c: torch.Tensor,
           x: torch.Tensor, n_bits: int) -> int:
    """Validates the operands; returns N."""
    N = alpha.shape[0] if alpha.dim() == 1 else -1
    for name, t, shape in (("seeds", seeds, (2, N, 4)), ("alpha", alpha, (N,)),
                           ("c", c, (N,)), ("x", x, (N,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"expected {name} as int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != alpha.device:
            raise ValueError(f"{name} on {t.device}, alpha on {alpha.device}")
    if N == 0:
        raise ValueError("dcf_sign needs at least one element")
    if not 1 <= n_bits <= 32:
        raise ValueError(f"n_bits must be in [1, 32], got {n_bits}")
    return N


def _words(t: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 in [0, 2^32), the plain PRG's word form."""
    return t.long() & MASK32


def dcf_sign_plain(seeds: torch.Tensor, alpha: torch.Tensor, c: torch.Tensor,
                   x: torch.Tensor, n_bits: int = 31) -> torch.Tensor:
    """The plain version: the key walk of both parties' seeds, then both
    parties' evaluation walks as one batch of two."""
    N = _check(seeds, alpha, c, x, n_bits)
    cw = _words(c)
    keys = dcf_gen_from_seeds(_words(seeds), _words(alpha), 1 - 2 * cw, n_bits)
    party = torch.tensor([[0], [1]], dtype=torch.int64, device=x.device)
    return dcf_eval(party, keys, _words(x).expand(2, N), n_bits)


@functools.cache
def _lib():
    """``csrc/dcf.cu``, built on first use, with its C signature."""
    from primia_tpu_torch.ops._build import load_library

    lib = load_library("dcf")
    vp = ctypes.c_void_p
    lib.dcf_sign.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, vp]
    lib.dcf_sign.restype = ctypes.c_int
    lib.dcf_error_string.argtypes = [ctypes.c_int]
    lib.dcf_error_string.restype = ctypes.c_char_p
    return lib


def dcf_sign(seeds: torch.Tensor, alpha: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
             n_bits: int = 31) -> torch.Tensor:
    """(2, N) int64 shares of (1 - 2c) * 1{x < alpha}: the plain version on
    the CPU, the kernel on CUDA."""
    N = _check(seeds, alpha, c, x, n_bits)
    if alpha.device.type == "cpu":
        return dcf_sign_plain(seeds, alpha, c, x, n_bits)
    if alpha.device.type != "cuda":
        raise RuntimeError(f"dcf_sign runs on CPU or CUDA tensors, not {alpha.device}")
    seeds, alpha, c, x = (t.contiguous() for t in (seeds, alpha, c, x))
    if seeds.data_ptr() % 16:  # the kernel reads a seed as one 16-byte load
        seeds = seeds.clone()
    out = torch.empty((2, N), dtype=torch.int64, device=alpha.device)
    lib = _lib()
    with torch.cuda.device(alpha.device):
        stream = torch.cuda.current_stream(alpha.device).cuda_stream
        err = lib.dcf_sign(seeds.data_ptr(), alpha.data_ptr(), c.data_ptr(), x.data_ptr(),
                           out.data_ptr(), N, n_bits, stream)
    if err != 0:
        raise RuntimeError(f"dcf_sign launch failed: CUDA error {err} "
                           f"({lib.dcf_error_string(err).decode()})")
    launches["dcf_sign"] += 1
    return out
