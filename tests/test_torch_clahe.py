"""CLAHE in the PyTorch port against the JAX package.

The port's plain versions (what its wrappers run on CPU tensors) are held
to the JAX package's CPU gather path and to its whole TPU function, both
Pallas kernels in interpret mode (the CUDA kernels are held to the plain
versions on the card by ``test_torch_cuda_kernels.py``). Inputs are made
with numpy and passed to both sides. The 3-channel path's plain version
is held to the composition it replaced, and what its kernel relies on
(the sRGB table, the L round trip it skips) is checked on every value it
can take.
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
from primia_tpu_torch.ops._build import read_launches
from primia_tpu_torch.ops.numerics import div


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
    got = cuda_clahe.clahe_channels(torch.from_numpy(x), 1.0, 8).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    d = _level_diff(got, ref)
    assert d.max() <= 1.0 + 1e-4
    assert (d > 1e-3).mean() <= 1e-3


def test_clahe_channels_channels_first_matches_nhwc():
    x = _u8(np.random.default_rng(1), (2, 48, 40, 2)).astype(np.float32) / 255.0
    nhwc = cuda_clahe.clahe_channels(torch.from_numpy(x))
    nchw = cuda_clahe.clahe_channels(torch.from_numpy(x).permute(0, 3, 1, 2),
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
    before = read_launches()
    luts = torch.full((3, 64, 256), -1.0)
    out = cuda_clahe.clahe_planes(p, luts_out=luts)
    assert read_launches() == before
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
    before = read_launches()
    out = cuda_clahe.clahe_planes(p)
    assert read_launches() == before
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


def _old_composition(imgs, clip_limit=1.0, tiles=8, channels_first=False):
    """``image.clahe`` on 3 channels as it was written before the 3-channel
    kernel: LAB in uint8, the per-channel CLAHE of L, back to RGB."""
    ch_ax = 1 if channels_first else -1
    lab = torch.round(timage.rgb_to_lab_u8(imgs, axis=ch_ax)).to(torch.uint8)
    L = lab.narrow(ch_ax, 0, 1)
    L_eq = cuda_clahe.clahe_channels(div(L.float(), 255.0), clip_limit, tiles,
                                     channels_first=channels_first)
    L_u8 = torch.round(L_eq.float() * 255.0).to(torch.uint8)
    lab = torch.cat([L_u8, lab.narrow(ch_ax, 1, 2)], dim=ch_ax)
    return timage.lab_u8_to_rgb(lab.float(), axis=ch_ax).to(imgs.dtype)


@pytest.mark.parametrize("layout", ["nhwc", "nchw", "nchw_view_of_nhwc"])
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 37, 45)])
def test_clahe_on_three_cpu_channels_equals_the_old_composition(layout, shape):
    """Bit for bit, NHWC and channels first (contiguous, and the predict
    steps' NCHW view of NHWC images), at a shape the tiles divide and a
    ragged one; the 3-channel route counts no launch on the CPU."""
    B, H, W = shape
    x = torch.from_numpy(np.random.default_rng(12).random((B, H, W, 3), dtype=np.float32))
    before = read_launches()
    if layout == "nhwc":
        got, want = timage.clahe(x), _old_composition(x)
    else:
        v = x.permute(0, 3, 1, 2)
        if layout == "nchw":
            v = v.contiguous()
        got = timage.clahe(v, channels_first=True)
        want = _old_composition(v, channels_first=True)
    assert read_launches() == before
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_clahe_rgb_on_cpu_runs_the_plain_version_without_counting():
    x = torch.from_numpy(np.random.default_rng(13).random((2, 3, 40, 48), dtype=np.float32))
    before = read_launches()
    out = cuda_clahe.clahe_rgb(x, 1.0, 8)
    assert read_launches() == before
    assert torch.equal(out, cuda_clahe.clahe_rgb_plain(x, 1.0, 8))
    assert out.shape == x.shape and out.is_contiguous()
    assert float(out.min()) >= 0 and float(out.max()) <= 1


def test_clahe_rgb_keeps_an_nhwc_layout():
    """The NCHW view of NHWC images comes back in the same layout, as the
    kernel writes it; contiguous NCHW comes back contiguous."""
    x = torch.from_numpy(np.random.default_rng(14).random((2, 32, 32, 3), dtype=np.float32))
    out = cuda_clahe.clahe_rgb(x.permute(0, 3, 1, 2))
    assert out.permute(0, 2, 3, 1).is_contiguous()
    assert torch.equal(out.contiguous(), cuda_clahe.clahe_rgb(x.permute(0, 3, 1, 2).contiguous()))


@pytest.mark.parametrize("x", [torch.zeros((2, 3, 16, 16), dtype=torch.float64),
                               torch.zeros((2, 3, 16, 16), dtype=torch.bfloat16),
                               torch.zeros((2, 1, 16, 16)), torch.zeros((2, 4, 16, 16)),
                               torch.zeros((3, 16, 16)), torch.zeros((1, 2, 3, 16, 16))],
                         ids=["float64", "bfloat16", "1-channel", "4-channel", "3-D", "5-D"])
def test_clahe_rgb_rejects_other_than_float32_three_channel_4d(x):
    with pytest.raises(ValueError):
        cuda_clahe.clahe_rgb(x)


def test_srgb_table_equals_the_plain_quantize_and_linearize():
    """The kernel looks ``_srgb_to_linear`` up at each channel's 8-bit level
    (floor(x 255 + 0.5), clamped). On every float32 from -2^-7 to 1 + 2^-7
    that is spaced no wider than 2^-24 around the 256 rounding edges, and
    on a dense grid elsewhere, table[level] equals the plain path's
    ``_srgb_to_linear(div(floor(...), 255))`` bit for bit."""
    edges = (np.arange(-1, 257, dtype=np.float64) + 0.5) / 255.0
    near = edges[:, None] + np.arange(-64, 65)[None, :] * 2.0 ** -24
    grid = np.linspace(-2.0 ** -7, 1.0 + 2.0 ** -7, 1 << 20)
    x = torch.from_numpy(np.concatenate([near.ravel(), grid]).astype(np.float32))
    q = torch.floor((x * 255.0 + 0.5).clamp(0, 255))
    assert bool(((q >= 0) & (q <= 255) & (q == q.round())).all())
    table = cuda_clahe.srgb_levels(torch.device("cpu"))
    assert table.shape == (256,) and table.dtype == torch.float32
    want = cuda_clahe._srgb_to_linear(div(q, 255.0))
    assert torch.equal(table[q.long()], want)


def test_the_l_round_trip_the_kernel_skips_is_the_identity():
    """The plain path hands L to the per-channel CLAHE as L / 255, which
    quantizes it again as (v 255 + 0.5) clamped and truncated: on each of
    the 256 levels that gives back L, so the kernel keeps L itself."""
    L = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 16, 16)
    v = div(L.float(), 255.0)
    back = (v * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    assert torch.equal(back, L)


def test_lab_constants_are_the_plain_path_numbers():
    """33 numbers, in ``LabConsts``'s order: the two matrices, then the
    scalars, each a finite float32."""
    k = np.asarray(cuda_clahe.lab_constants(), np.float64)
    assert k.shape == (33,) and np.isfinite(k.astype(np.float32)).all()
    np.testing.assert_array_equal(k[:9], cuda_clahe._RGB2XYZ.ravel())
    np.testing.assert_array_equal(k[9:18], np.linalg.inv(cuda_clahe._RGB2XYZ).ravel())
    assert k[22] == cuda_clahe._LAB_KAPPA * cuda_clahe._LAB_EPS and k[23] == 1.0 / 3.0
