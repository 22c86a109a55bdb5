"""CLAHE in the PyTorch port against the JAX package.

The port's plain versions (what its wrappers run on CPU tensors) are
held to the JAX package's CPU gather path and, for the LUT stage, to the
Pallas kernel in interpret mode (the CUDA kernels are held to the
plain versions on the card by ``test_torch_cuda_kernels.py``). Inputs
are made with numpy and passed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.ops import image as jimage
from primia_tpu.ops.pallas_clahe import clahe_luts as jax_clahe_luts
from primia_tpu_torch.ops import cuda_clahe
from primia_tpu_torch.ops import image as timage


def _u8(rng, shape):
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _level_diff(a, b):
    """|a - b| in uint8 levels for [0, 1] images."""
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)) * 255.0


@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (1, 224, 224, 1), (2, 60, 60, 1)])
def test_clahe_channels_matches_jax_gather_path(shape):
    """Limit: at most 1 level, on at most 1e-3 of the pixels (the JAX
    side may contract the bilinear mix into FMAs)."""
    x = _u8(np.random.default_rng(0), shape).astype(np.float32) / 255.0
    ref = np.asarray(jimage._clahe_channels(jnp.asarray(x), 1.0, 8))
    got = timage._clahe_channels(torch.from_numpy(x), 1.0, 8).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    d = _level_diff(got, ref)
    assert d.max() <= 1.0 + 1e-4
    assert (d > 1e-3).mean() <= 1e-3


def test_clahe_channels_channels_first_matches_nhwc():
    x = _u8(np.random.default_rng(1), (2, 48, 40, 2)).astype(np.float32) / 255.0
    nhwc = timage._clahe_channels(torch.from_numpy(x))
    nchw = timage._clahe_channels(torch.from_numpy(x).permute(0, 3, 1, 2),
                                  channels_first=True)
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), nhwc, rtol=0, atol=0)


def test_lut_stage_matches_pallas_interpret():
    """The LUTs are integers computed from exact sums: equal bit for bit."""
    x = _u8(np.random.default_rng(2), (2, 64, 64, 1))
    ref = np.asarray(jax_clahe_luts(jnp.asarray(x.astype(np.float32) / 255.0),
                                    1.0, 8, interpret=True))
    got = cuda_clahe.clahe_luts(torch.from_numpy(x[..., 0].copy()), 1.0, 8).numpy()
    assert got.shape == (2, 64, 256)
    np.testing.assert_array_equal(got, ref[:, :64])


@pytest.mark.parametrize("channels_first", [False, True])
def test_clahe_lab_path_matches_jax(channels_first):
    """3 channels go through LAB, equalising L only. Limit: 2 levels
    (the LAB conversions' pow/cbrt differ in the last float bits, which
    can move a rounding by one level on either side of CLAHE)."""
    x = _u8(np.random.default_rng(3), (2, 64, 64, 3)).astype(np.float32) / 255.0
    ref = np.asarray(jimage.clahe(jnp.asarray(x), 1.0, 8))
    t = torch.from_numpy(x)
    if channels_first:
        got = timage.clahe(t.permute(0, 3, 1, 2), 1.0, 8, channels_first=True)
        got = got.permute(0, 2, 3, 1)
    else:
        got = timage.clahe(t, 1.0, 8)
    assert _level_diff(got.numpy(), ref).max() <= 2.0 + 1e-4


def test_rgb_to_lab_u8_matches_jax():
    x = np.random.default_rng(4).random((2, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jimage.rgb_to_lab_u8(jnp.asarray(x)))
    got = timage.rgb_to_lab_u8(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_lab_u8_to_rgb_matches_jax():
    lab = (np.random.default_rng(5).random((2, 32, 32, 3)) * 255.0).astype(np.float32)
    ref = np.asarray(jimage.lab_u8_to_rgb(jnp.asarray(lab)))
    got = timage.lab_u8_to_rgb(torch.from_numpy(lab)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_cpu_tensors_run_the_plain_versions_without_counting():
    p = torch.from_numpy(_u8(np.random.default_rng(6), (3, 40, 40)))
    before = dict(cuda_clahe.launches)
    luts = cuda_clahe.clahe_luts(p)
    out = cuda_clahe.clahe_apply(p, luts)
    assert cuda_clahe.launches == before
    torch.testing.assert_close(luts, cuda_clahe.clahe_luts_plain(p), rtol=0, atol=0)
    torch.testing.assert_close(out, cuda_clahe.clahe_apply_plain(p, luts), rtol=0, atol=0)
    assert out.shape == (3, 40, 40) and float(out.min()) >= 0 and float(out.max()) <= 255


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        cuda_clahe.clahe_luts(torch.zeros((2, 8, 8), dtype=torch.float32))
    p = torch.zeros((2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_clahe.clahe_apply(p, torch.zeros((2, 63, 256)))

