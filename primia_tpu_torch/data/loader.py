"""Fixed-shape batch iteration over materialized uint8 arrays.

Port of ``primia_tpu/data/loader.py`` (``Batch`` and ``BatchLoader``).
Batches are sliced as numpy on the host; the final partial batch is
padded to the batch size with a validity mask, so every step sees one
shape.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Optional

import numpy as np


class Batch(NamedTuple):
    images: np.ndarray  # (B, R, R, C) uint8
    labels: Optional[np.ndarray]  # (B,) int32 or None
    mask: np.ndarray  # (B,) float32; 0 for padding rows


class BatchLoader:
    """Shuffling fixed-shape batch iterator over materialized arrays."""

    def __init__(
        self,
        images: np.ndarray,
        labels: Optional[np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        pad_final: bool = True,
    ):
        self.images = images
        self.labels = labels
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_final = pad_final
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return -(-len(self.images) // self.batch_size)

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.images)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        B = self.batch_size
        for b in range(len(self)):
            idx = order[b * B : (b + 1) * B]
            imgs = self.images[idx]
            labs = self.labels[idx] if self.labels is not None else None
            mask = np.ones(len(idx), np.float32)
            if len(idx) < B and self.pad_final:
                pad = B - len(idx)
                imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]), imgs.dtype)])
                if labs is not None:
                    labs = np.concatenate([labs, np.zeros(pad, labs.dtype)])
                mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield Batch(imgs, labs, mask)
