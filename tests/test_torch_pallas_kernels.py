"""K5 (Gaussian noise) and K6 (the bilinear warp of
``PRIMIA_PALLAS_AUGMENT``) against the JAX package's
``ops/pallas_kernels.py``, on the CPU.

K6's contract (bilinear, zero fill outside) is the port's
``warp_affine(twopass=False)`` on K2, with or without the switch: it is
held to ``resample_bilinear_pallas`` in interpret mode, which samples
with float32 tent matmuls there, at the source coordinates of the same
affine maps. K5 cannot be held to its TPU kernel's values, which come
from the TPU's hardware generator (which JAX's interpret mode does not
emulate on the CPU): its plain version is checked as
``tests/test_pallas.py`` checks the kernel (mean, standard deviation,
distinct rows), its Philox against the Random123 known answer and a
numpy reference, its pairs against a float64 Box-Muller, its moments,
its mapping from element to words across row lengths, its launch plan,
and for repeatability. Each test states its limit.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.ops.pallas_kernels import resample_bilinear_pallas
from primia_tpu_torch.ops import cuda_kernels, cuda_tent
from primia_tpu_torch.ops import image as port_image
from primia_tpu_torch.ops.image import affine_coords, warp_affine


# ------------------------------------------------------------------ K6

@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mats(rng, B):
    """Inverse affine maps with rotation, scale, shear and translations
    that carry part of each output off the image (zero fill)."""
    m = np.tile(np.eye(2, 3, dtype=np.float32), (B, 1, 1))
    m[:, :, :2] += rng.uniform(-0.4, 0.4, (B, 2, 2)).astype(np.float32)
    m[:, :, 2] = rng.uniform(-6.0, 6.0, (B, 2)).astype(np.float32)
    return torch.from_numpy(m)


# tests/test_pallas.py's shapes and a non-square one
@pytest.mark.parametrize("B,H,W,C", [(2, 32, 32, 1), (1, 16, 16, 3), (2, 24, 20, 3)])
def test_resample_bilinear_matches_the_pallas_kernel(B, H, W, C):
    """``warp_affine(twopass=False)`` (NHWC) within 1e-5 of K6 at the
    maps' source coordinates: both sample bilinearly with zero fill in
    float32."""
    rng = np.random.default_rng(H + C)
    imgs = rng.random((B, H, W, C), dtype=np.float32)
    mats = _mats(rng, B)
    sy, sx = affine_coords(mats, H, W)
    want = np.asarray(resample_bilinear_pallas(jnp.asarray(imgs), jnp.asarray(sy.numpy()),
                                               jnp.asarray(sx.numpy()), interpret=True))
    got = warp_affine(torch.from_numpy(imgs), mats, twopass=False)
    assert got.shape == (B, H, W, C) and got.dtype == torch.float32
    assert float((sy < 0).float().mean() + (sx < 0).float().mean()) > 0  # some zero fill
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("value", ["1", "0", "yes"])
def test_warp_affine_goes_through_k6_under_the_switch(monkeypatch, value):
    """Under PRIMIA_PALLAS_AUGMENT (any value) ``warp_affine(twopass=False)``
    is K6's contract on K2 as without it: one ``tent_bilinear`` call a
    warp and the same values, NCHW and NHWC; the two-pass warp stays K1."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((2, 3, 20, 24), dtype=np.float32))
    mats = torch.tensor([[[0.9, 0.3, 1.5], [-0.2, 1.1, -0.5]],
                         [[1.2, -0.4, 0.0], [0.5, 0.8, 2.0]]])
    monkeypatch.delenv("PRIMIA_PALLAS_AUGMENT", raising=False)
    ref = warp_affine(x, mats, twopass=False, channels_first=True)
    monkeypatch.setenv("PRIMIA_PALLAS_AUGMENT", value)
    calls = []
    orig = cuda_tent.tent_bilinear
    with mock.patch.object(port_image, "tent_bilinear",
                           lambda *a: calls.append(1) or orig(*a)):
        got = warp_affine(x, mats, twopass=False, channels_first=True)
        got_nhwc = warp_affine(x.permute(0, 2, 3, 1), mats, twopass=False)
        warp_affine(x, mats, twopass=True, channels_first=True)  # K1, not K2
    assert len(calls) == 2
    torch.testing.assert_close(got, ref, rtol=0, atol=0)
    torch.testing.assert_close(got_nhwc, ref.permute(0, 2, 3, 1), rtol=0, atol=0)


# ------------------------------------------------------------------ K5

def test_philox_matches_the_random123_known_answer():
    """Philox-4x32-10 of counter 0 under key 0 is 0x6627e8d5, 0xe169c58d,
    0xbc57ac4c, 0x9b00dbd8 (Random123's kat_vectors): all four words."""
    words = cuda_kernels.philox_words_plain(1, 1, 0, "cpu")
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]


def _philox_numpy(seed, row, g):
    """Philox-4x32-10 in numpy uint64 arithmetic at counter (g mod 2^32,
    g >> 32, 0, 0) under key (seed, row): the four words."""
    m = np.uint64(0xFFFFFFFF)
    c = [np.uint64(g & 0xFFFFFFFF), np.uint64(g >> 32), np.uint64(0), np.uint64(0)]
    k = [np.uint64(seed & 0xFFFFFFFF), np.uint64(row)]
    for r in range(10):
        if r:
            k = [(k[0] + np.uint64(0x9E3779B9)) & m, (k[1] + np.uint64(0xBB67AE85)) & m]
        p0, p1 = np.uint64(0xD2511F53) * c[0], np.uint64(0xCD9E8D57) * c[2]
        c = [(p1 >> np.uint64(32)) ^ c[1] ^ k[0], p1 & m, (p0 >> np.uint64(32)) ^ c[3] ^ k[1],
             p0 & m]
    return [int(w) for w in c]


def _uniforms_numpy(seed, row, j):
    """Element j's (u1, u2) by the group mapping: group j >> 2's words,
    (w0, w1) for its first pair and (w2, w3) for its second."""
    w = _philox_numpy(seed, row, j >> 2)
    a, b = w[2 * ((j >> 1) & 1):][:2]
    return np.float32(np.float32(a >> 8) * np.float32(2.0 ** -24) + np.float32(1e-7)), \
        np.float32(np.float32(b >> 8) * np.float32(2.0 ** -24))


def test_philox_words_match_a_uint64_reference():
    """Every word of every group equal, over rows, groups and a seed above
    2^31; each element's uniforms are its group's words by the mapping."""
    seed = 0xDEADBEEF
    words = cuda_kernels.philox_words_plain(3, 40, seed, "cpu")
    u1, u2 = cuda_kernels.noise_uniforms_plain(3, 159, seed, "cpu")
    for row in range(3):
        for g in (0, 1, 17, 39):
            assert [int(w[row, g]) for w in words] == _philox_numpy(seed, row, g)
        for j in (0, 1, 2, 3, 70, 157, 158):
            assert (u1[row, j].item(), u2[row, j].item()) == _uniforms_numpy(seed, row, j)


def test_pairs_share_uniforms_and_take_both_box_muller_branches():
    """Elements 2p and 2p + 1 share their uniforms, and their noise is
    sigma r cos(2 pi u2) and sigma r sin(2 pi u2) of a float64 Box-Muller
    of those uniforms within 1e-6 (sigma 0.1, r at most 5.68: float32's
    log, sqrt, cos and 2 pi u2 are a few 1e-7 of the noise)."""
    u1, u2 = cuda_kernels.noise_uniforms_plain(3, 1000, 9, "cpu")
    torch.testing.assert_close(u1[:, 0::2], u1[:, 1::2], rtol=0, atol=0)
    torch.testing.assert_close(u2[:, 0::2], u2[:, 1::2], rtol=0, atol=0)
    assert not torch.equal(u1[:, 0::2][:, :-1], u1[:, 2::2])  # pairs differ from each other
    noise = cuda_kernels.add_gaussian_noise(torch.zeros(3, 1000), 9, 0.1).double().numpy()
    a, b = u1[:, 0::2].double().numpy(), u2[:, 0::2].double().numpy()
    r = np.sqrt(-2.0 * np.log(a))
    np.testing.assert_allclose(noise[:, 0::2], 0.1 * r * np.cos(2 * np.pi * b), rtol=0, atol=1e-6)
    np.testing.assert_allclose(noise[:, 1::2], 0.1 * r * np.sin(2 * np.pi * b), rtol=0, atol=1e-6)


def test_noise_moments_at_a_million_samples():
    """2^20 plain samples of N(0, 1) (4 rows): |mean| < 0.005 and |std - 1|
    < 0.005 (standard errors 0.001 and 0.0007), each pair's cosine and sine
    elements uncorrelated, |corr| < 0.007 (5 standard errors of 2^19
    pairs), the share beyond 3 sigma 0.0027 +- 0.0003 (6 standard errors)
    and the excess kurtosis within +-0.025 (5 standard errors)."""
    z = cuda_kernels.add_gaussian_noise(torch.zeros(4, 1 << 18), 21, 1.0).double()
    assert abs(float(z.mean())) < 0.005 and abs(float(z.std()) - 1.0) < 0.005
    pairs = z.reshape(-1, 2)
    assert abs(float(torch.corrcoef(pairs.T)[0, 1])) < 0.007
    assert abs(float((z.abs() > 3.0).double().mean()) - 0.0027) < 0.0003
    zc = z - z.mean()
    assert abs(float((zc ** 4).mean() / zc.var() ** 2) - 3.0) < 0.025


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unaligned_and_ragged_rows_keep_each_elements_stream(dtype):
    """A row of n = 4,995 (off the four-element grid, its last group of 3)
    and one of n = 2 (a single ragged group) give each element the value
    it has in a row of 5,000 of the same stream: the mapping from element
    to words does not depend on the row's length or alignment."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((7, 5000), dtype=np.float32)).to(dtype)
    whole = cuda_kernels.add_gaussian_noise(x, 31, 0.1)
    for n in (4995, 2):
        part = cuda_kernels.add_gaussian_noise(x[:, :n].contiguous(), 31, 0.1)
        torch.testing.assert_close(part, whole[:, :n], rtol=0, atol=0)
    u_whole = cuda_kernels.noise_uniforms_plain(7, 5000, 31, "cpu")
    for a, b in zip(cuda_kernels.noise_uniforms_plain(7, 4995, 31, "cpu"), u_whole):
        torch.testing.assert_close(a, b[:, :4995], rtol=0, atol=0)


def _walk(plan, rows, threads):
    """The items the kernel's grid stride visits (csrc/noise.cu), thread by
    thread: [(row, group), ...]."""
    seen = []
    for t in range(plan.grid * threads):
        row, g = divmod(t, plan.groups)
        while row < rows:
            seen.append((row, g))
            g, row = g + plan.step_groups, row + plan.step_rows
            if g >= plan.groups:
                g, row = g - plan.groups, row + 1
    return seen


@pytest.mark.parametrize("rows,n,blocks_per_sm,sms", [
    (3, 5000, 2, 2),     # several items a thread
    (7, 4995, 8, 132),   # fewer items than one wave: a block past them is not planned
    (600, 1, 1, 3),      # one-element rows: a stride of many rows
    (5, 37, 1, 1),       # one block
])
def test_noise_plan_visits_every_group_once_in_one_wave(rows, n, blocks_per_sm, sms):
    """Every (row, group) item exactly once, four elements a group with the
    last one ragged; the grid at most one wave of the card and no more
    blocks than the items need."""
    threads = cuda_kernels.NOISE_THREADS
    plan = cuda_kernels.plan_noise(rows, n, blocks_per_sm, sms)
    assert plan.groups * 4 >= n > (plan.groups - 1) * 4
    assert plan.grid <= blocks_per_sm * sms
    assert (plan.grid - 1) * threads < rows * plan.groups
    seen = _walk(plan, rows, threads)
    assert sorted(seen) == [(r, g) for r in range(rows) for g in range(plan.groups)]


def test_noise_distribution_and_rows():
    """As tests/test_pallas.py holds the TPU kernel: on zeros, the noise
    over sigma has |mean| < 0.05 and |std - 1| < 0.05, and rows differ."""
    x = torch.zeros((4, 64, 64, 1))
    out = cuda_kernels.add_gaussian_noise(x, 3, 0.1)
    n = out.numpy().ravel() / 0.1
    assert abs(n.mean()) < 0.05 and abs(n.std() - 1.0) < 0.05
    assert not torch.equal(out[0], out[1])
    assert out.shape == x.shape and out.dtype == torch.float32


def test_noise_repeats_with_the_seed_and_adds_to_x():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.random((3, 2, 10, 10), dtype=np.float32))
    a = cuda_kernels.add_gaussian_noise(x, 11, 0.05)
    torch.testing.assert_close(a, cuda_kernels.add_gaussian_noise(x, 11, 0.05), rtol=0, atol=0)
    assert not torch.equal(a, cuda_kernels.add_gaussian_noise(x, 12, 0.05))
    zero = cuda_kernels.add_gaussian_noise(torch.zeros_like(x), 11, 0.05)
    torch.testing.assert_close(a, x + zero, rtol=0, atol=1e-6)
    xb = x.to(torch.bfloat16)
    b = cuda_kernels.add_gaussian_noise(xb, 11, 0.05)
    assert b.dtype == torch.bfloat16
    torch.testing.assert_close(b, xb + zero.to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError):
        cuda_kernels.add_gaussian_noise(x.double(), 11, 0.05)


def test_noise_uniforms_are_top_24_bits():
    """u1 in (0, 1] (1e-7 added), u2 in [0, 1), both multiples of 2^-24
    (u1 before the offset); the CPU wrapper is the plain version."""
    u1, u2 = cuda_kernels.noise_uniforms(torch.zeros(2, 500), 5)
    p1, p2 = cuda_kernels.noise_uniforms_plain(2, 500, 5, "cpu")
    torch.testing.assert_close(u1, p1, rtol=0, atol=0)
    torch.testing.assert_close(u2, p2, rtol=0, atol=0)
    assert float(u1.min()) > 0.0 and float(u1.max()) <= 1.0
    assert float(u2.min()) >= 0.0 and float(u2.max()) < 1.0
    k = u2.double() * 2 ** 24
    assert torch.equal(k, k.round())

