"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (a
hand-written kernel has no CPU mode). The file imports nothing of JAX,
so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.ops import cuda_clahe, cuda_tent
from primia_tpu_torch.ops.image import (_clahe_channels, clahe, rgb_to_lab_u8, warp_affine,
                                        warp_dense)


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


# -------------------------------------------------- the warp kernels K1, K2

# (images, channels, H, W): the canonical train batch and a ragged one
TENT_SHAPES = [(200, 3, 224, 224), (3, 2, 60, 72)]


def _tent_operands(shape, device, seed=11):
    B, C, H, W = shape
    rng = np.random.default_rng(seed)
    planes = torch.from_numpy(rng.random((B * C, H, W), dtype=np.float32)).to(device)
    # positions spread past both edges, with some integers (exact taps)
    ys = rng.uniform(-3.0, H + 2.0, (B, H, W)).astype(np.float32)
    xs = rng.uniform(-3.0, W + 2.0, (B, H, W)).astype(np.float32)
    ys[:, ::7] = np.round(ys[:, ::7])
    xs[:, :, ::5] = np.round(xs[:, :, ::5])
    return planes, torch.from_numpy(ys).to(device), torch.from_numpy(xs).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TENT_SHAPES)
@pytest.mark.parametrize("axis", [1, 2])
def test_tent_rows_matches_plain(cuda_device, shape, axis):
    """Bit for bit: the kernel rounds every product and sum as the plain
    version does."""
    planes, ys, xs = _tent_operands(shape, cuda_device)
    q = ys if axis == 1 else xs
    before = cuda_tent.launches["tent_rows"]
    got = cuda_tent.tent_rows(planes, q, axis=axis)
    torch.testing.assert_close(got, cuda_tent.tent_rows_plain(planes, q, axis=axis),
                               rtol=0, atol=0)
    assert cuda_tent.launches["tent_rows"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", TENT_SHAPES)
def test_tent_bilinear_matches_plain(cuda_device, shape):
    planes, ys, xs = _tent_operands(shape, cuda_device)
    before = cuda_tent.launches["tent_bilinear"]
    got = cuda_tent.tent_bilinear(planes, ys, xs, max_dy=4.0)
    torch.testing.assert_close(got, cuda_tent.tent_bilinear_plain(planes, ys, xs),
                               rtol=0, atol=0)
    assert cuda_tent.launches["tent_bilinear"] == before + 1


@pytest.mark.cuda
def test_warps_on_the_card_count_their_launches(cuda_device, monkeypatch):
    """Two K1 launches per two-pass warp, one K2 launch per gather warp."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((2, 3, 40, 40), dtype=np.float32)).to(cuda_device)
    mats = torch.tensor([[[1.0, 0.1, 0.5], [-0.1, 1.0, -0.5]]] * 2, device=cuda_device)
    d = torch.zeros((2, 40, 40), device=cuda_device)
    before = dict(cuda_tent.launches)
    warp_affine(x, mats, twopass=True, channels_first=True)
    warp_dense(x, d, d, channels_first=True)
    assert cuda_tent.launches["tent_rows"] == before["tent_rows"] + 4
    warp_affine(x, mats, twopass=False, channels_first=True)
    monkeypatch.setenv("PRIMIA_WARP_TWOPASS", "0")
    torch.testing.assert_close(warp_dense(x, d, d, channels_first=True), x, rtol=0, atol=0)
    assert cuda_tent.launches["tent_bilinear"] == before["tent_bilinear"] + 2


@pytest.mark.cuda
def test_tent_kernels_reject_bad_operands(cuda_device):
    planes, ys, xs = _tent_operands((2, 3, 16, 16), cuda_device)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes.double(), ys)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes, ys[:, :8])
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes[:5], ys)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(planes, ys.cpu())
    with pytest.raises(ValueError):
        cuda_tent.tent_bilinear(planes, ys, xs[:1])
    with pytest.raises(ValueError):
        cuda_tent.tent_bilinear(planes, ys, xs.cpu())
