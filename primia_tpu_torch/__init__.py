"""PriMIA on PyTorch and CUDA: the port of ``primia_tpu`` to an NVIDIA H100.

Laid out module for module like the JAX package, which stays the
reference each module is tested against. Plain tensor code is PyTorch;
the TPU's Pallas kernels become CUDA kernels written by hand
(``csrc/``), built at first use by ``ops/_build.py``.

Entry points run on CUDA unless the caller asks for the CPU; without a
card the default raises instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

DEVICES = ("cuda", "cpu")


def default_device() -> torch.device:
    """The CUDA device, or a clear error on a host without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; primia_tpu_torch runs on CUDA by "
            "default (pass --device cpu, or device='cpu', to run on the CPU)")
    return torch.device("cuda")


def resolve_device(name: str = "cuda") -> torch.device:
    """``"cuda"`` (checked by :func:`default_device`) or ``"cpu"``."""
    if name == "cuda":
        return default_device()
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown device {name!r}; choose from {DEVICES}")
