"""The warp kernels' plain versions (K1 ``tent_rows``, K2 ``tent_bilinear``)
and the port's warps against the JAX package.

The port computes the TPU's default warp semantics on every device, so
its two-pass warps are held to the functions the TPU runs: the XLA
``warp_affine_twopass`` (float32 on the CPU, rtol = atol = 1e-5, the
order of the tent sums) and the Pallas kernels in interpret mode. The
Pallas kernels round their input, their intermediate and their output to
bf16, so those comparisons use inputs exact in bf16 (k/256) and
atol = 8e-3. The exact gather K2 is held to ``jax.vmap(bilinear_sample)``
at 1e-6, and to the TPU's bf16 tent contraction at 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.ops import image as jax_image
from primia_tpu.ops.pallas_tent import (resample_tent_pallas, warp_affine_shear_pallas,
                                        warp_dense_twopass_pallas)
from primia_tpu_torch.ops import cuda_tent
from primia_tpu_torch.ops import image as port_image

# (images, H, W, channels): square, non-square, and ragged (W % 128 != 0,
# H != W, one channel)
SHAPES = [(2, 32, 32, 3), (3, 36, 52, 1), (2, 60, 44, 3)]


def _imgs(shape, seed, bf16_exact=False):
    rng = np.random.default_rng(seed)
    if bf16_exact:
        return (rng.integers(0, 256, shape) / 256.0).astype(np.float32)
    return rng.random(shape, dtype=np.float32)


def _mats(B, seed, rotation=30.0, shear=10.0, scale=0.15, translate=0.1, R=32):
    """Inverse affine matrices from numpy draws over the canonical ranges,
    through the port's ``_affine_mats_from``."""
    from primia_tpu_torch.ops.augment import _affine_mats_from

    rng = np.random.default_rng(seed)
    f = lambda lo, hi, n: torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32))
    return _affine_mats_from(f(-rotation, rotation, B), f(-translate, translate, (B, 2)),
                             f(1 - scale, 1 + scale, B), f(-shear, shear, B), R).numpy()


def _nhwc(t):
    return torch.from_numpy(t)


@pytest.mark.parametrize("shape", SHAPES)
def test_twopass_affine_matches_xla_twopass(shape):
    imgs = _imgs(shape, 0)
    mats = _mats(shape[0], 1, R=shape[1])
    assert jax_image.twopass_safe(30.0, 10.0, 0.15)
    ref = np.asarray(jax_image.warp_affine_twopass(jnp.asarray(imgs), jnp.asarray(mats)))
    got = port_image.warp_affine(_nhwc(imgs), torch.from_numpy(mats), twopass=True).numpy()
    assert ref.dtype == got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_twopass_affine_matches_the_tpu_kernel(shape):
    imgs = _imgs(shape, 2, bf16_exact=True)
    mats = _mats(shape[0], 3, R=shape[1])
    ref = np.asarray(warp_affine_shear_pallas(jnp.asarray(imgs), jnp.asarray(mats),
                                              interpret=True))
    got = port_image.warp_affine(_nhwc(imgs), torch.from_numpy(mats), twopass=True).numpy()
    np.testing.assert_allclose(got, ref, atol=8e-3)


def test_twopass_affine_channels_first_is_the_same_warp():
    imgs = _imgs(SHAPES[0], 4)
    mats = torch.from_numpy(_mats(2, 5))
    nhwc = port_image.warp_affine(_nhwc(imgs), mats, twopass=True)
    nchw = port_image.warp_affine(_nhwc(imgs).permute(0, 3, 1, 2), mats, twopass=True,
                                  channels_first=True)
    torch.testing.assert_close(nchw.permute(0, 2, 3, 1), nhwc, rtol=0, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
def test_gather_affine_matches_jax(shape):
    """``twopass=False`` is K2, the exact bilinear gather: the JAX warp on
    the CPU samples with ``bilinear_sample``."""
    imgs = _imgs(shape, 6)
    mats = _mats(shape[0], 7, rotation=80.0, R=shape[1])
    ref = np.asarray(jax_image.warp_affine(jnp.asarray(imgs), jnp.asarray(mats)))
    got = port_image.warp_affine(_nhwc(imgs), torch.from_numpy(mats), twopass=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def _smooth_field(B, H, W, amp, seed):
    from primia_tpu_torch.ops.augment import _coarse_field_from

    rng = np.random.default_rng(seed)
    f = torch.from_numpy(rng.uniform(-1, 1, (B, 2, 6, 6)).astype(np.float32))
    dy, dx = _coarse_field_from(f, H, W, torch.full((B,), amp))
    return dy.numpy(), dx.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_twopass_dense_matches_the_tpu_kernel(shape):
    B, H, W, _ = shape
    imgs = _imgs(shape, 8, bf16_exact=True)
    dy, dx = _smooth_field(B, H, W, 3.0, 9)
    ref = np.asarray(warp_dense_twopass_pallas(jnp.asarray(imgs), jnp.asarray(dy),
                                               jnp.asarray(dx), interpret=True))
    got = port_image.warp_dense(_nhwc(imgs), torch.from_numpy(dy), torch.from_numpy(dx))
    np.testing.assert_allclose(got.numpy(), ref, atol=8e-3)


def test_twopass_dense_identity_is_exact():
    imgs = _imgs(SHAPES[1], 10, bf16_exact=True)
    z = torch.zeros(imgs.shape[:3])
    got = port_image.warp_dense(_nhwc(imgs), z, z)
    np.testing.assert_array_equal(got.numpy(), imgs)
    ref = np.asarray(warp_dense_twopass_pallas(jnp.asarray(imgs), jnp.asarray(z.numpy()),
                                               jnp.asarray(z.numpy()), interpret=True))
    np.testing.assert_array_equal(ref, imgs)


@pytest.mark.parametrize("aligned", ["dy", "dx"])
def test_twopass_dense_axis_aligned_fields_are_exact(aligned):
    """With one field zero the two passes are one exact 1-D lerp: equal to
    the bilinear gather, and to the TPU kernel within its bf16 rounding."""
    imgs = _imgs((2, 32, 40, 2), 11, bf16_exact=True)
    B, H, W, _ = imgs.shape
    rng = np.random.default_rng(12)
    d = rng.uniform(-4.0, 4.0, (B, H, W)).astype(np.float32)
    z = np.zeros_like(d)
    dy, dx = (d, z) if aligned == "dy" else (z, d)
    got = port_image.warp_dense(_nhwc(imgs), torch.from_numpy(dy), torch.from_numpy(dx))
    rr, cc = np.mgrid[0:H, 0:W].astype(np.float32)
    want = np.asarray(jax.vmap(jax_image.bilinear_sample)(
        jnp.asarray(imgs), jnp.asarray(rr + dy), jnp.asarray(cc + dx)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    ref = np.asarray(warp_dense_twopass_pallas(jnp.asarray(imgs), jnp.asarray(dy),
                                               jnp.asarray(dx), interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, atol=8e-3)


def test_dense_warp_without_twopass_is_the_gather(monkeypatch):
    """``PRIMIA_WARP_TWOPASS=0`` switches the math to the joint bilinear
    sample (K2), as in the JAX package."""
    imgs = _imgs(SHAPES[0], 13)
    B, H, W, _ = imgs.shape
    dy, dx = _smooth_field(B, H, W, 3.0, 14)
    monkeypatch.setenv("PRIMIA_WARP_TWOPASS", "0")
    ref = np.asarray(jax_image.warp_dense(jnp.asarray(imgs), jnp.asarray(dy), jnp.asarray(dx)))
    got = port_image.warp_dense(_nhwc(imgs), torch.from_numpy(dy), torch.from_numpy(dx),
                                max_dy=6.0)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


def _coords(B, H, W, Ho, Wo, seed):
    rng = np.random.default_rng(seed)
    ys = rng.uniform(-3.0, H + 2.0, (B, Ho, Wo)).astype(np.float32)
    xs = rng.uniform(-3.0, W + 2.0, (B, Ho, Wo)).astype(np.float32)
    ys[:, ::5] = np.round(ys[:, ::5])  # integer rows: taps exactly on pixels
    return ys, xs


@pytest.mark.parametrize("shape,out", [((2, 32, 40, 3), (32, 40)), ((3, 48, 48, 1), (11, 13)),
                                       ((2, 60, 44, 3), (60, 44))])
def test_tent_bilinear_plain_matches_bilinear_sample(shape, out):
    B, H, W, C = shape
    imgs = _imgs(shape, 15)
    ys, xs = _coords(B, H, W, *out, 16)
    planes = torch.from_numpy(imgs).permute(0, 3, 1, 2).reshape(B * C, H, W).contiguous()
    got = cuda_tent.tent_bilinear(planes, torch.from_numpy(ys), torch.from_numpy(xs))
    got = got.reshape(B, C, *out).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(jax.vmap(jax_image.bilinear_sample)(jnp.asarray(imgs), jnp.asarray(ys),
                                                        jnp.asarray(xs)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    one = port_image.bilinear_sample(torch.from_numpy(imgs[0]), torch.from_numpy(ys[0]),
                                     torch.from_numpy(xs[0]))
    np.testing.assert_allclose(one.numpy(), ref[0], atol=1e-6)


@pytest.mark.parametrize("max_dy", [None, 4.0])
def test_tent_bilinear_plain_matches_the_tpu_kernel(max_dy):
    B, H, W, C = 2, 32, 32, 3
    imgs = _imgs((B, H, W, C), 17)
    rng = np.random.default_rng(18)
    rr, cc = np.mgrid[0:H, 0:W].astype(np.float32)
    ys = (rr + rng.uniform(-3.5, 3.5, (B, H, W))).astype(np.float32)
    xs = (cc + rng.uniform(-3.5, 3.5, (B, H, W))).astype(np.float32)
    ref = np.asarray(resample_tent_pallas(jnp.asarray(imgs), jnp.asarray(ys), jnp.asarray(xs),
                                          max_dy=max_dy, interpret=True))
    planes = torch.from_numpy(imgs).permute(0, 3, 1, 2).reshape(B * C, H, W).contiguous()
    got = cuda_tent.tent_bilinear(planes, torch.from_numpy(ys), torch.from_numpy(xs),
                                  max_dy=max_dy)
    got = got.reshape(B, C, H, W).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-2)


@pytest.mark.parametrize("axis", [1, 2])
def test_tent_rows_plain_is_the_tent_contraction(axis):
    """K1's plain version against its definition, a tent-weighted sum over
    the axis (the XLA form of the two-pass warp): zero fill outside
    [-1, L]."""
    rng = np.random.default_rng(19)
    B, C, H, W = 2, 3, 20, 28
    planes = rng.random((B * C, H, W), dtype=np.float32)
    L = W if axis == 2 else H
    q = rng.uniform(-2.5, L + 1.5, (B, H, W)).astype(np.float32)
    got = cuda_tent.tent_rows(torch.from_numpy(planes), torch.from_numpy(q), axis=axis).numpy()
    k = np.arange(L, dtype=np.float64)
    qn = np.repeat(q, C, axis=0).astype(np.float64)
    w = np.clip(1.0 - np.abs(qn[..., None] - k), 0.0, 1.0)  # (N, H, W, L)
    if axis == 2:
        want = np.einsum("nijk,nik->nij", w, planes)
    else:
        want = np.einsum("nijk,nkj->nij", w, planes)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_wrappers_reject_bad_operands():
    p = torch.zeros((6, 8, 8))
    q = torch.zeros((2, 8, 8))
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(p.double(), q)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(p, q[:, :4])
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(p[:5], q)
    with pytest.raises(ValueError):
        cuda_tent.tent_rows(p, q, axis=0)
    with pytest.raises(ValueError):
        cuda_tent.tent_bilinear(p, q, q[:1])


def test_static_warp_bounds_match_jax():
    for rot, shear, scale in [(30, 10, 0.15), (80, 10, 0.15), (0, 0, 0.95), (45, 0, 0.3)]:
        assert port_image.twopass_safe(rot, shear, scale) == jax_image.twopass_safe(
            rot, shear, scale)
        assert port_image.affine_row_band(rot, shear, scale, 224) == jax_image.affine_row_band(
            rot, shear, scale, 224)
