"""MNIST: the reference's ``--data_dir mnist`` "weak machine" path.

Port of ``primia_tpu/data/mnist.py`` (reference ``train.py:99-129``). No
download: the loader reads the standard IDX files, raw or gzipped, from
``$MNIST_DIR``, ``data/MNIST/raw``, ``mnist`` or ``data/mnist``, and fails
with an actionable message otherwise. :func:`write_idx` writes the same
format (synthetic sets for tests and smoke runs).

``label_subset`` is the reference's ``LabelMNIST``
(``torchlib/dataloader.py:258-263``): restrict to a list of digit labels.
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}

CLASSES = [str(i) for i in range(10)]


def _find_root(root: Optional[str] = None) -> Path:
    candidates = [root] if root else []
    candidates += [os.environ.get("MNIST_DIR"), "data/MNIST/raw", "mnist", "data/mnist"]
    for c in candidates:
        if c and any((Path(c) / f"train-labels-idx1-ubyte{ext}").exists() for ext in ("", ".gz")):
            return Path(c)
    raise FileNotFoundError(
        "MNIST IDX files not found. Place train-images-idx3-ubyte[.gz], "
        "train-labels-idx1-ubyte[.gz], t10k-* under data/MNIST/raw (or set "
        "$MNIST_DIR). There is no network egress, so they cannot be downloaded "
        "automatically.")


def _read_idx(path: Path) -> np.ndarray:
    """An unsigned-byte IDX file (raw, or ``<path>.gz``) as an array."""
    gz = path.with_name(path.name + ".gz")
    if path.exists():
        data = path.read_bytes()
    elif gz.exists():
        data = gzip.decompress(gz.read_bytes())
    else:
        raise FileNotFoundError(path)
    magic, = struct.unpack(">I", data[:4])
    ndim = magic & 0xFF
    dims = struct.unpack(f">{ndim}I", data[4:4 + 4 * ndim])
    return np.frombuffer(data, np.uint8, offset=4 + 4 * ndim).reshape(dims)


def write_idx(path, array: np.ndarray, compress: bool = False) -> None:
    """``array`` (uint8) as an IDX file: magic ``0x08`` (unsigned byte) and
    the number of dimensions, the dimensions big-endian, the bytes;
    gzipped when ``compress``."""
    a = np.ascontiguousarray(array, dtype=np.uint8)
    data = struct.pack(">I", 0x0800 | a.ndim) + struct.pack(f">{a.ndim}I", *a.shape) \
        + a.tobytes()
    Path(path).write_bytes(gzip.compress(data) if compress else data)


def load_mnist(root: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(train_imgs u8 (N, 28, 28, 1), train_labels i32, test_imgs, test_labels)."""
    r = _find_root(root)
    tri = _read_idx(r / FILES["train_images"])[..., None]
    trl = _read_idx(r / FILES["train_labels"]).astype(np.int32)
    tei = _read_idx(r / FILES["test_images"])[..., None]
    tel = _read_idx(r / FILES["test_labels"]).astype(np.int32)
    return tri, trl, tei, tel


def label_subset(images: np.ndarray, labels: np.ndarray,
                 keep: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Reference ``LabelMNIST``: restrict to the given digit labels."""
    mask = np.isin(labels, list(keep))
    return images[mask], labels[mask]


def resize_to(images_u8: np.ndarray, resolution: int) -> np.ndarray:
    """Upscale 28x28 digits to the training resolution (uint8), through
    :func:`primia_tpu_torch.native.resize_bilinear`, as the JAX package's."""
    if images_u8.shape[1] == resolution:
        return images_u8
    from primia_tpu_torch import native

    return native.resize_bilinear(images_u8, resolution, resolution)
