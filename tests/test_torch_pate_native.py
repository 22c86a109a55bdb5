"""The port's PATE accountant and native host library against the JAX
package's, on the same numpy inputs: equal floats for PATE, equal bytes
for the four native functions (with the library and under
``PRIMIA_NO_NATIVE=1``), and MNIST's upscale through the native resize."""

import numpy as np
import pytest
import torch

from primia_tpu import native as jnative
from primia_tpu.data import mnist as jmnist
from primia_tpu.train import pate as jpate
from primia_tpu_torch import native
from primia_tpu_torch.data import mnist
from primia_tpu_torch.train import pate


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _votes(seed, n_teachers=50, n_examples=40, n_labels=10):
    rng = np.random.default_rng(seed)
    # a few confident examples and a few split ones
    p = rng.dirichlet(np.full(n_labels, 0.3), n_examples)
    return np.stack([[rng.choice(n_labels, p=p[i]) for i in range(n_examples)]
                     for _ in range(n_teachers)])


@pytest.mark.parametrize("seed", [0, 1])
def test_pate_accountant_equals_jax(seed):
    votes = _votes(seed)
    counts = pate.votes_to_counts(votes, 10)
    np.testing.assert_array_equal(counts, jpate.votes_to_counts(votes, 10))
    for row in counts[:12]:
        for eps in (0.05, 0.1, 0.5):
            assert pate.compute_q_noisy_max(row, eps) == jpate.compute_q_noisy_max(row, eps)
            for l in (1.0, 4.0, 8.0):
                assert pate.smoothed_sens(row, eps, l, 0.09) == \
                    jpate.smoothed_sens(row, eps, l, 0.09)
    idx = np.arange(0, 40, 3)
    for eps in (0.05, 0.2):
        got = pate.perform_analysis(votes, idx, eps, delta=1e-5)
        assert got == jpate.perform_analysis(votes, idx, eps, delta=1e-5)
        assert all(np.isfinite(got)) and got[0] <= got[1]
    with pytest.raises(ValueError, match="out of range"):
        pate.perform_analysis(votes, [40], 0.1)


@pytest.fixture(params=["library", "numpy"])
def native_mode(request, monkeypatch):
    """Both packages' native modules with their library, or both on their
    numpy paths (``PRIMIA_NO_NATIVE=1``), loaded afresh."""
    for mod in (native, jnative):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    if request.param == "numpy":
        monkeypatch.setenv("PRIMIA_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("PRIMIA_NO_NATIVE", raising=False)
    assert native.available() == jnative.available() == (request.param == "library")
    return request.param


def test_native_functions_are_bit_equal_to_jax(native_mode):
    rng = np.random.default_rng(7)
    for seed in (1234, b"\x01" * 40, 2 ** 100):
        assert native.sha256_keystream(seed, 100).tobytes() == \
            jnative.sha256_keystream(seed, 100).tobytes()
    x = rng.uniform(-50, 50, (3, 17, 5)).astype(np.float32)
    x[0, 0, :4] = [(2 * i + 1) / 2 / 65536 for i in range(4)]  # exact .5 ties
    for frac, seed in ((16, 42), (12, b"node-secret")):
        got, ref = native.encode_and_share(x, frac, seed), jnative.encode_and_share(x, frac, seed)
        for a, b in zip(got, ref):
            assert a.dtype == b.dtype == np.int64 and a.tobytes() == b.tobytes()
        rec = (got[0].view(np.uint64) + got[1].view(np.uint64)).view(np.int64)
        np.testing.assert_array_equal(
            rec, np.round(x.astype(np.float64) * (1 << frac)).astype(np.int64))
    u16 = rng.integers(0, 4096, (37, 45), dtype=np.uint16)
    assert native.percentile_stretch(u16).tobytes() == jnative.percentile_stretch(u16).tobytes()
    assert native.percentile_stretch(u16, 2.0, 98.0).tobytes() == \
        jnative.percentile_stretch(u16, 2.0, 98.0).tobytes()
    for c in (1, 3):
        imgs = rng.integers(0, 256, (2, 28, 31, c), dtype=np.uint8)
        for oh, ow in ((64, 64), (17, 50)):
            got = native.resize_bilinear(imgs, oh, ow)
            assert got.shape == (2, oh, ow, c)
            assert got.tobytes() == jnative.resize_bilinear(imgs, oh, ow).tobytes()


def test_native_library_builds_apart_from_the_jax_package():
    path = native.library_path(native.CXXFLAGS + ("-fopenmp",) + native.LDFLAGS)
    assert path.parent == native.BUILD_DIR and path.parent.name == "primia_tpu_torch"
    assert path != jnative._LIB_PATH


def test_mnist_resize_to_64_px_equals_jax(native_mode):
    imgs = np.random.default_rng(3).integers(0, 256, (5, 28, 28, 1), dtype=np.uint8)
    got = mnist.resize_to(imgs, 64)
    assert got.shape == (5, 64, 64, 1) and got.dtype == np.uint8
    assert got.tobytes() == jmnist.resize_to(imgs, 64).tobytes()
