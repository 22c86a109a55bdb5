"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (a
hand-written kernel has no CPU mode). The file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.ops import cuda_clahe
from primia_tpu_torch.ops.image import _clahe_channels, clahe, rgb_to_lab_u8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _planes(shape, device, seed=7):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 224, 224), (64, 224, 224), (3, 60, 60)])
def test_clahe_kernels_match_plain_versions(cuda_device, shape):
    """LUTs equal; the apply stage within 1 level on at most 1e-4 of the
    pixels."""
    p = _planes(shape, cuda_device)
    before = dict(cuda_clahe.launches)
    luts = cuda_clahe.clahe_luts(p)
    torch.testing.assert_close(luts, cuda_clahe.clahe_luts_plain(p), rtol=0, atol=0)
    out = cuda_clahe.clahe_apply(p, luts)
    d = (out - cuda_clahe.clahe_apply_plain(p, luts)).abs()
    assert float(d.max()) <= 1.0
    assert float((d > 1e-3).float().mean()) <= 1e-4
    assert cuda_clahe.launches["clahe_lut"] == before["clahe_lut"] + 1
    assert cuda_clahe.launches["clahe_apply"] == before["clahe_apply"] + 1


@pytest.mark.cuda
def test_clahe_channels_on_the_card_equal_the_cpu(cuda_device):
    """Equal: the kernels are exact against the plain versions, and those
    divide as IEEE division on both devices."""
    rng = np.random.default_rng(9)
    L = torch.from_numpy(rng.integers(0, 256, (2, 1, 224, 224), dtype=np.uint8)) / 255.0
    got = _clahe_channels(L.to(cuda_device), channels_first=True).cpu()
    torch.testing.assert_close(got, _clahe_channels(L, channels_first=True), rtol=0, atol=0)


@pytest.mark.cuda
def test_lab_path_on_the_card_against_the_cpu(cuda_device):
    """The elementwise pow of the LAB conversion differs in its last bits
    between the devices: LAB within 1e-4. A few rounded L values then
    flip by one level, which moves their tiles' LUTs, so the whole path
    is held by the share of pixels more than 1 level apart: at most 1e-4."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.random((2, 3, 224, 224), dtype=np.float32))
    lab = rgb_to_lab_u8(x.to(cuda_device), axis=1).cpu()
    torch.testing.assert_close(lab, rgb_to_lab_u8(x, axis=1), rtol=0, atol=1e-4)
    d = (clahe(x.to(cuda_device), channels_first=True).cpu() - clahe(x, channels_first=True))
    assert float((d.abs() * 255.0 > 1.0 + 1e-3).float().mean()) <= 1e-4


@pytest.mark.cuda
def test_kernels_reject_non_cuda_devices_and_bad_shapes(cuda_device):
    p = _planes((2, 32, 32), cuda_device)
    with pytest.raises(ValueError):
        cuda_clahe.clahe_apply(p, torch.zeros((2, 64, 256), device=cuda_device)[:, :63])
    with pytest.raises(ValueError):
        cuda_clahe.clahe_apply(p, torch.zeros((2, 64, 256)))
