"""The port's MNIST loader against the JAX package's, on synthetic IDX
files written under ``tmp_path`` (no download): every array equal, dtypes
included."""

import numpy as np
import pytest

from primia_tpu.data import mnist as jmnist
from primia_tpu_torch.data import mnist


def _write_set(root, compress, seed=0, n_train=40, n_test=12):
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    ext = ".gz" if compress else ""
    for split, n in (("train", n_train), ("t10k", n_test)):
        mnist.write_idx(root / f"{split}-images-idx3-ubyte{ext}",
                        rng.integers(0, 256, (n, 28, 28), dtype=np.uint8), compress)
        mnist.write_idx(root / f"{split}-labels-idx1-ubyte{ext}",
                        rng.integers(0, 10, n).astype(np.uint8), compress)


@pytest.mark.parametrize("compress", [False, True], ids=["raw", "gz"])
def test_load_mnist_matches_jax(tmp_path, monkeypatch, compress):
    _write_set(tmp_path / "idx", compress)
    got = mnist.load_mnist(str(tmp_path / "idx"))
    ref = jmnist.load_mnist(str(tmp_path / "idx"))
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (40, 28, 28, 1) and got[1].dtype == np.int32
    # found through $MNIST_DIR as the JAX loader finds it
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "idx"))
    monkeypatch.chdir(tmp_path)
    for a, b in zip(mnist.load_mnist(), jmnist.load_mnist()):
        np.testing.assert_array_equal(a, b)
    assert mnist.CLASSES == jmnist.CLASSES


def test_missing_files_raise_with_the_places_searched(tmp_path, monkeypatch):
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="MNIST_DIR"):
        mnist.load_mnist()


def test_label_subset_matches_jax():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (50, 28, 28, 1), dtype=np.uint8)
    labels = rng.integers(0, 10, 50).astype(np.int32)
    for keep in ([0, 1, 2], [9], [], list(range(10))):
        for a, b in zip(mnist.label_subset(imgs, labels, keep),
                        jmnist.label_subset(imgs, labels, keep)):
            np.testing.assert_array_equal(a, b)


def test_resize_to_is_the_identity_at_28_px_and_names_its_port_elsewhere():
    imgs = np.random.default_rng(2).integers(0, 256, (3, 28, 28, 1), dtype=np.uint8)
    assert mnist.resize_to(imgs, 28) is imgs
    assert jmnist.resize_to(imgs, 28) is imgs
    with pytest.raises(NotImplementedError, match="native.py"):
        mnist.resize_to(imgs, 224)
