"""The port's augmentation chain against the JAX package's.

Per op, each package gets the same inputs and the same draws (the JAX
draws are reproduced from its keys and handed to the port):
atol = 1e-5 (float32, sums in another order), exact for ``equalize``.
The whole chain is held by what is deterministic (every probability 0
equals ``normalize_only``; a deterministic op at p = 1 equals JAX) and,
since the two packages draw from different generators, by distribution:
the gate rates against the configured probabilities, and the moments of
the canonical chain's output against the JAX chain's.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.ops import augment as jax_aug
from primia_tpu.ops import image as jax_image
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.ops import augment as port_aug
from primia_tpu_torch.ops import image as port_image

ROOT = Path(__file__).resolve().parent.parent
CANONICAL = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained.ini"
MEAN = np.array([0.45, 0.46, 0.47])
STD = np.array([0.22, 0.23, 0.24])
ATOL = 1e-5


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def test_affine_mats_from_jax_draws():
    cfg = jax_aug.AugmentConfig(rotation=30.0, translate=0.1, scale=0.15, shear=10.0,
                                inference_resolution=224)
    key = jax.random.PRNGKey(3)
    B = 16
    ref = np.asarray(jax_aug._affine_mats(key, cfg, B))
    kr, kt, ks, kh = jax.random.split(key, 4)
    u = lambda k, shape, lo, hi: torch.from_numpy(np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi, dtype=jnp.float32)))
    got = port_aug._affine_mats_from(u(kr, (B,), -30.0, 30.0), u(kt, (B, 2), -0.1, 0.1),
                                     u(ks, (B,), 0.85, 1.15), u(kh, (B,), -10.0, 10.0), 224)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("H,W,coarse", [(32, 32, 4), (40, 28, 6)])
def test_coarse_field_from_jax_draws(H, W, coarse):
    key = jax.random.PRNGKey(4)
    amp = np.array([2.0, 0.5, 0.0], np.float32)
    ref_dy, ref_dx = jax_aug._coarse_field(key, 3, H, W, coarse, jnp.asarray(amp))
    f = np.asarray(jax.random.uniform(key, (3, 2, coarse, coarse), minval=-1.0, maxval=1.0,
                                      dtype=jnp.float32))
    dy, dx = port_aug._coarse_field_from(torch.from_numpy(f), H, W, torch.from_numpy(amp))
    np.testing.assert_allclose(dy.numpy(), np.asarray(ref_dy), atol=ATOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), atol=ATOL)


@pytest.mark.parametrize("channels_first", [False, True])
def test_box_blur_matches_jax(channels_first):
    x = np.random.default_rng(5).random((2, 20, 24, 3), dtype=np.float32)
    if channels_first:
        x = np.ascontiguousarray(_nchw(x))
    ref = np.asarray(jax_image.box_blur(jnp.asarray(x), 3, channels_first=channels_first))
    got = port_image.box_blur(torch.from_numpy(x), 3, channels_first=channels_first)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("channels_first", [False, True])
def test_equalize_matches_jax_exactly(channels_first):
    x = (_u8((3, 24, 20, 3), 6) // 3 + 40).astype(np.float32) / 255.0  # a narrow histogram
    if channels_first:
        x = np.ascontiguousarray(_nchw(x))
    ref = np.asarray(jax_image.equalize(jnp.asarray(x), channels_first=channels_first))
    got = port_image.equalize(torch.from_numpy(x), channels_first=channels_first)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hsv_round_trip_matches_jax():
    x = np.random.default_rng(7).random((2, 16, 16, 3), dtype=np.float32)
    ref_hsv = np.asarray(jax_aug._hsv_impl(jnp.asarray(x)))
    hsv = port_aug._hsv_impl(torch.from_numpy(x))
    np.testing.assert_allclose(hsv.numpy(), ref_hsv, atol=ATOL)
    ref_rgb = np.asarray(jax_aug._hsv_to_rgb(jnp.asarray(ref_hsv)))
    rgb = port_aug._hsv_to_rgb(torch.from_numpy(ref_hsv))
    np.testing.assert_allclose(rgb.numpy(), ref_rgb, atol=ATOL)
    np.testing.assert_allclose(rgb.numpy(), x, atol=1e-4)
    first = port_aug._hsv_impl(torch.from_numpy(_nchw(x)), axis=1)
    np.testing.assert_allclose(first.numpy(), _nchw(ref_hsv), atol=ATOL)


@pytest.mark.parametrize("size", [(48, 40), (20, 16)])
def test_resize_bilinear_matches_jax(size):
    x = np.random.default_rng(8).random((2, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jax_image.resize_bilinear(jnp.asarray(x), size))
    got = port_image.resize_bilinear(torch.from_numpy(x), size)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_normalize_only_matches_jax():
    u8 = _u8((3, 16, 16, 3), 9)
    ref = np.asarray(jax_aug.normalize_only(jnp.asarray(u8), MEAN, STD, 3))
    got = port_aug.normalize_only(torch.from_numpy(u8), MEAN, STD, 3)
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=ATOL)


_ALL_OPS = dict(clahe=False, randomgamma=True, randombrightness=True, blur=True, elastic=True,
                optical_distortion=True, grid_distortion=True, grid_shuffle=True, hsv=True,
                invert=True, cutout=True, shadow=True, fog=True, sun_flare=True,
                solarize=True, equalize=True, grid_dropout=True)


def test_chain_with_every_probability_zero_is_normalize_only():
    """Every op of the chain on, every gate at probability 0: the dense
    warp runs with zero fields, which two-pass is exact."""
    cfg = port_aug.AugmentConfig(train_resolution=32, inference_resolution=32,
                                 overall_prob=0.0, individual_prob=0.0, noise_std=0.05,
                                 noise_prob=0.0, **_ALL_OPS)
    u8 = torch.from_numpy(_u8((4, 32, 32, 3), 10))
    got = port_aug.build_augment_fn(cfg, MEAN, STD, 3)(torch.Generator().manual_seed(0), u8)
    want = port_aug.normalize_only(u8, MEAN, STD, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("op", ["invert", "solarize"])
def test_chain_with_one_deterministic_op_matches_jax(op):
    """p = 1 everywhere: the flip and the op apply to every image in both
    packages."""
    kw = {op: True}
    u8 = _u8((3, 32, 32, 3), 11)
    jcfg = jax_aug.AugmentConfig(train_resolution=32, inference_resolution=32, **kw)
    ref = jax_aug.build_augment_fn(jcfg, MEAN, STD, 3)(jax.random.PRNGKey(0), jnp.asarray(u8))
    pcfg = port_aug.AugmentConfig(train_resolution=32, inference_resolution=32, **kw)
    got = port_aug.build_augment_fn(pcfg, MEAN, STD, 3)(torch.Generator().manual_seed(0),
                                                        torch.from_numpy(u8))
    np.testing.assert_allclose(got.numpy(), _nchw(ref), atol=1e-6)


def _changed(out, u8):
    """Per image: does the chain's output differ from normalize_only?"""
    base = port_aug.normalize_only(torch.from_numpy(u8), MEAN, STD, 3)
    return (out - base).abs().amax(dim=(1, 2, 3)) > 1e-4


@pytest.mark.parametrize("op,rate", [("invert", 0.75 * 0.2), ("noise", 0.5)])
def test_gate_rates_match_the_probabilities(op, rate):
    """Constant images (a flip changes nothing) through the canonical
    gates: the share of images changed is the configured probability,
    within 4 binomial standard deviations over 1024 images."""
    levels = np.random.default_rng(12).integers(30, 220, 1024).astype(np.uint8)
    u8 = np.broadcast_to(levels[:, None, None, None], (1024, 8, 8, 3)).copy()
    kw = dict(invert=True) if op == "invert" else dict(noise_std=0.05, noise_prob=0.5)
    cfg = port_aug.AugmentConfig(train_resolution=8, inference_resolution=8,
                                 overall_prob=0.75, individual_prob=0.2, **kw)
    out = port_aug.build_augment_fn(cfg, MEAN, STD, 3)(torch.Generator().manual_seed(1),
                                                       torch.from_numpy(u8))
    share = float(_changed(out, u8).float().mean())
    assert abs(share - rate) <= 4 * np.sqrt(rate * (1 - rate) / 1024)


def test_canonical_chain_distribution_matches_jax():
    """The canonical recipe at 32 px, batch 64: finite, the right shape,
    and per-channel mean and std of the normalised output within 0.15
    of the JAX chain's on the same images (the chains draw differently)."""
    def cfg_of(cls):
        args = cls.from_ini(CANONICAL)
        args.train_resolution = args.inference_resolution = 32
        return args

    jcfg = jax_aug.AugmentConfig.from_args(cfg_of(JaxArguments))
    pcfg = port_aug.AugmentConfig.from_args(cfg_of(Arguments))
    assert pcfg._asdict() == jcfg._asdict()
    rng = np.random.default_rng(13)
    yy, xx = np.mgrid[0:32, 0:32]
    blob = 60 + 120 * np.exp(-((yy - 16) ** 2 + (xx - 14) ** 2) / 120.0)
    u8 = np.clip(blob[None, :, :, None] + rng.normal(0, 15, (64, 32, 32, 3)), 0, 255)
    u8 = u8.astype(np.uint8)
    ref = _nchw(jax_aug.build_augment_fn(jcfg, MEAN, STD, 3)(jax.random.PRNGKey(1),
                                                             jnp.asarray(u8)))
    got = port_aug.build_augment_fn(pcfg, MEAN, STD, 3)(torch.Generator().manual_seed(1),
                                                        torch.from_numpy(u8)).numpy()
    assert got.shape == ref.shape == (64, 3, 32, 32) and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got.mean(axis=(0, 2, 3)), ref.mean(axis=(0, 2, 3)), atol=0.15)
    np.testing.assert_allclose(got.std(axis=(0, 2, 3)), ref.std(axis=(0, 2, 3)), atol=0.15)


def test_crop_is_a_window_of_the_input():
    cfg = port_aug.AugmentConfig(train_resolution=24, inference_resolution=32,
                                 overall_prob=0.0)
    u8 = _u8((5, 32, 32, 3), 14)
    out = port_aug.build_augment_fn(cfg, np.zeros(3), np.ones(3), 3)(
        torch.Generator().manual_seed(2), torch.from_numpy(u8))
    full = port_aug.normalize_only(torch.from_numpy(u8), np.zeros(3), np.ones(3), 3)
    for b in range(5):
        hits = [(i, j) for i in range(9) for j in range(9)
                if torch.equal(out[b], full[b, :, i:i + 24, j:j + 24])]
        assert len(hits) >= 1
