"""CLAHE in the PyTorch port against the JAX package.

The port's plain version (what its wrapper runs on CPU tensors) is held
to the JAX package's CPU gather path and to its whole TPU function, both
Pallas kernels in interpret mode (the CUDA kernel is held to the plain
version on the card by ``test_torch_cuda_kernels.py``). Inputs are made
with numpy and passed to both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.ops import image as jimage
from primia_tpu.ops.pallas_clahe import clahe_luts as jax_clahe_luts
from primia_tpu.ops.pallas_clahe import clahe_pallas as jax_clahe_pallas
from primia_tpu_torch.ops import cuda_clahe
from primia_tpu_torch.ops import image as timage


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.mark.parametrize("shape", [(2, 64, 64, 1), (2, 60, 60, 1)])
def test_planes_match_the_whole_pallas_function(shape):
    """The TPU function (both pallas_calls in interpret mode, its packed
    corner apply and the / 255) against the plain composite. Limit: 1e-4
    uint8 levels; the test finds 1.52e-5 at both shapes, one float32 ulp
    of the [0, 1] output (the Pallas apply sums the four weighted corners
    in another order)."""
    x = _u8(np.random.default_rng(10), shape)
    ref = np.asarray(jax_clahe_pallas(jnp.asarray(x.astype(np.float32) / 255.0), 1.0, 8,
                                      interpret=True))
    got = cuda_clahe.clahe_planes_plain(torch.from_numpy(x[..., 0].copy()), 1.0, 8).numpy()
    assert got.shape == ref.shape[:3] and got.dtype == np.float32
    assert _level_diff(got, ref[..., 0]).max() <= 1e-4


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
    luts = torch.full((3, 64, 256), -1.0)
    out = cuda_clahe.clahe_planes(p, luts_out=luts)
    assert cuda_clahe.launches == before
    torch.testing.assert_close(luts, cuda_clahe.clahe_luts_plain(p), rtol=0, atol=0)
    torch.testing.assert_close(cuda_clahe.clahe_luts(p), luts, rtol=0, atol=0)
    torch.testing.assert_close(out, cuda_clahe.clahe_planes_plain(p), rtol=0, atol=0)
    apply = cuda_clahe.clahe_apply_plain(p, luts)
    torch.testing.assert_close(out, apply / torch.tensor(255.0), rtol=0, atol=0)
    assert out.shape == (3, 40, 40) and float(out.min()) >= 0 and float(out.max()) <= 1


def test_planes_on_cpu_run_the_plain_composite_without_counting():
    """clahe_planes on a CPU tensor is the plain composite, low-entropy
    planes included, and counts no launch."""
    rng = np.random.default_rng(11)
    flat = np.zeros((40, 40), np.uint8)
    mostly = np.where(rng.random((40, 40)) < 0.9, 77, rng.integers(0, 256, (40, 40)))
    ramp = np.add.outer(np.arange(40), np.arange(40)).astype(np.uint8)
    p = torch.from_numpy(np.stack([flat, mostly.astype(np.uint8), ramp]))
    before = dict(cuda_clahe.launches)
    out = cuda_clahe.clahe_planes(p)
    assert cuda_clahe.launches == before
    want = cuda_clahe.clahe_planes_plain(p)
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    assert bool(torch.isfinite(out).all()) and float(out.min()) >= 0 and float(out.max()) <= 1


@pytest.mark.parametrize("planes", [torch.zeros((2, 8, 8), dtype=torch.float32),
                                    torch.zeros((2, 1, 8, 8), dtype=torch.uint8),
                                    torch.zeros((8, 8), dtype=torch.uint8)],
                         ids=["float32", "4-D", "2-D"])
def test_planes_reject_non_uint8_or_non_3d_input(planes):
    with pytest.raises(ValueError):
        cuda_clahe.clahe_planes(planes)


def test_wrappers_reject_bad_inputs():
    with pytest.raises(ValueError):
        cuda_clahe.clahe_luts(torch.zeros((2, 8, 8), dtype=torch.float32))
    p = torch.zeros((2, 16, 16), dtype=torch.uint8)
    with pytest.raises(ValueError):
        cuda_clahe.clahe_planes(p, luts_out=torch.zeros((2, 63, 256)))


def _rn32_unambiguous(v64):
    """float64 values rounded to float32, with a check that none lies
    exactly halfway between two float32 values (where rounding a float64
    that was itself rounded could differ from rounding the exact value)."""
    low = v64.view(np.uint64) & np.uint64((1 << 29) - 1)
    assert not (low == np.uint64(1 << 28)).any()
    return v64.astype(np.float32)


def test_kernel_division_by_255_is_the_ieee_quotient():
    """The CLAHE kernel divides by 255 as q0 = RN(v y), y = RN(1/255), then
    RN(q0 + RN(v - 255 q0) y) (two FMAs). For every float32 v in
    [2^-30, 256), which holds every nonzero value the kernel divides, that
    equals the IEEE quotient. Exact arithmetic in float64: 255 q0 and r y
    are exact there, so only the final roundings are checked for ties."""
    y32 = np.float32(1.0) / np.float32(255.0)
    y = np.float64(y32)
    lo = int(np.float32(2.0 ** -30).view(np.uint32))
    hi = int(np.float32(256.0).view(np.uint32))
    step = 1 << 22
    for start in range(lo, hi, step):
        v32 = np.arange(start, min(start + step, hi), dtype=np.uint32).view(np.float32)
        v = v32.astype(np.float64)
        q0 = (v32 * y32).astype(np.float64)
        r = v - 255.0 * q0
        assert (r.astype(np.float32).astype(np.float64) == r).all()  # the FMA's r is exact
        got = _rn32_unambiguous(q0 + r * y)
        want = _rn32_unambiguous(v / 255.0)
        np.testing.assert_array_equal(got, want)
