"""The benchmark's frozen arithmetic: model MACs from a configuration's
shapes (each family's count lives beside its plain forward), the bytes and operations of the port's kernels, the operations of
the encrypted forward's Beaver products, and the card's peaks.

Peaks: NVIDIA's data sheet of the H100 SXM (80 GB HBM3), dense rates, at
its full power limit of 700 W. A card set below that limit runs slower
under load; the harness prints the limit beside each run.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_HBM_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12          # dense bf16 tensor cores
PEAK_INT8_OPS = 1979e12           # dense int8 tensor cores
SM_COUNT, INT32_LANES_PER_SM, SM_MAX_HZ = 132, 64, 1.98e9
PEAK_INT32_OPS = SM_COUNT * INT32_LANES_PER_SM * SM_MAX_HZ

# K4, csrc/dcf.cu: a Threefry-2x32-20 block is 20 rotations and 20 xors on
# the INT32 lanes (its adds can issue as IMAD on the FMA pipe); the blocks
# of one seed share the counter's second word, so their first rotation is
# one. A level's key walk runs both children of both parties' seeds
# (2 x 6 blocks); past the first level where x and alpha differ, the
# merged evaluation walk runs 3 blocks of one seed. 44 bytes in (8 seed
# words, alpha, c, x) and 16 out an element. 31 levels: the 31-bit
# comparison domain of mpc/compare.py.
DCF_LEVELS = 31
DCF_KEY_OPS_PER_LEVEL = 2 * (6 * 40 - 5)
DCF_EVAL_OPS_PER_LEVEL = 3 * 40 - 2
DCF_BYTES_PER_ELEMENT = 60

# A product of two ring elements mod 2^64 from signed-byte limbs: the limb
# pairs (i, j) with i + j < 8 are the ones that reach the low 64 bits,
# 8 * 9 / 2 = 36 int8 products, each a multiply and an add a MAC.
LIMB_PRODUCTS = 36
# A two-party Beaver product of a shared input x and shared weights W:
# the dealer's c = a * b; each party's delta * b_i and a_i * eps; party
# 0's delta * eps. Six ring products of the layer's shape.
BEAVER_RING_PRODUCTS = 6


def conv_macs(cin: int, cout: int, k: int, h_out: int, w_out: int) -> int:
    return cin * cout * k * k * h_out * w_out


def out_size(n: int, k: int, s: int, p: int) -> int:
    return (n + 2 * p - k) // s + 1


def layer_macs(arch: dict, num_classes: int = None) -> Tuple[int, int]:
    """(conv MACs, linear MACs) of one image through the configuration's
    architecture, counted by its family's file
    (``benchmark/reference/families/<family>.py``, ``macs``);
    ``num_classes`` overrides its head's width."""
    import importlib

    fam = importlib.import_module(f"benchmark.reference.families.{arch['family']}")
    return fam.macs(arch, arch["num_classes"] if num_classes is None else num_classes)


def train_flops_per_image(arch: dict) -> int:
    """Model FLOPs of one image in a train step: forward and backward are
    3 x 2 x the conv and linear MACs."""
    return 6 * sum(layer_macs(arch))


def encrypted_int8_ops_per_image(arch: dict) -> int:
    """Int8 tensor-core operations that an exact Z_2^64 forward of one image
    needs in its linear layers: MACs x Beaver ring products x limb
    products x 2 (a multiply and an add)."""
    return sum(layer_macs(arch)) * BEAVER_RING_PRODUCTS * LIMB_PRODUCTS * 2


def k1_bytes(planes_shape: Iterable[int], coords_shape: Iterable[int]) -> int:
    """One K1 call (csrc/tent.cu tent_rows): float32 planes (N, H, W) and the
    per-image field (B, H, W) read once, float32 (N, H, W) written once."""
    n, h, w = planes_shape
    b, hc, wc = coords_shape
    return 4 * (2 * n * h * w + b * hc * wc)


def dcf_int32_ops(alpha, x) -> int:
    """INT32-lane operations K4 needs for these inputs (int32 tensors of one
    call): the key walk at every level, the merged evaluation past the
    first level where x and alpha differ (the bit length of alpha ^ x,
    less one)."""
    import torch

    diff = (alpha.long() ^ x.long()) & 0xFFFFFFFF
    bit_length = torch.frexp(diff.double()).exponent.long()
    past = int((bit_length - 1).clamp(min=0).sum())
    return alpha.shape[0] * DCF_LEVELS * DCF_KEY_OPS_PER_LEVEL + past * DCF_EVAL_OPS_PER_LEVEL


def dcf_least_seconds(n: int, int32_ops: int) -> float:
    """K4's least time for one call: the larger of its INT32 operations at
    the lanes' peak and its bytes at HBM's."""
    return max(int32_ops / PEAK_INT32_OPS, n * DCF_BYTES_PER_ELEMENT / PEAK_HBM_BYTES_PER_S)
