"""Fixed-shape batch iteration, device upload and dataset statistics.

Port of ``primia_tpu/data/loader.py``. Batches are sliced from the
materialised uint8 ``(N, R, R, C)`` array on the host, or, after
:func:`to_device_resident`, gathered on the card. A final partial batch
is padded to the batch size with a validity mask (or dropped), so every
step sees one shape.
"""

from __future__ import annotations

import collections
from typing import Iterable, Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from primia_tpu_torch.utils import count_h2d, span

Images = Union[np.ndarray, torch.Tensor]


class Batch(NamedTuple):
    images: Images  # (B, R, R, C) uint8
    labels: Optional[np.ndarray]  # (B,) int32 or None
    mask: np.ndarray  # (B,) float32; 0 for padding rows


def to_device_resident(images_u8: np.ndarray, device, max_bytes: int = 4 << 30) -> Images:
    """The dataset as a uint8 tensor on the card when it fits in
    ``max_bytes`` (the chest X-ray training set is about 260 MB at
    224 px), so batches become gathers on the card instead of per-step
    uploads. On the CPU, or when larger, the host array is returned."""
    device = torch.device(device)
    if device.type == "cpu" or images_u8.nbytes > max_bytes:
        return images_u8
    return torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)


def _upload(a, device: torch.device):
    if a is None:
        return None
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def device_prefetch(batches: Iterable[Batch], device, depth: int = 2) -> Iterator[Batch]:
    """Iterates ``batches`` with the next ``depth`` already on their way
    to ``device``: host arrays go up from pinned memory with
    ``non_blocking=True``, so the copies overlap the running step."""
    device = torch.device(device)
    q = collections.deque()
    it = iter(batches)

    def put(b: Batch) -> Batch:
        return Batch(*(_upload(a, device) for a in b))

    for b in it:
        q.append(put(b))
        if len(q) > depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def calc_mean_std(images_u8: np.ndarray,
                  sample_limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel mean and std (Bessel-corrected) of a uint8 NHWC array
    over [0, 1] floats (reference ``calc_mean_std``,
    ``torchlib/dataloader.py:220``), from exact integer moments."""
    x = images_u8
    if sample_limit is not None and len(x) > sample_limit:
        idx = np.linspace(0, len(x) - 1, sample_limit).astype(np.int64)
        x = x[idx]
    c = x.shape[-1]
    n = x.size // c
    # sum <= N*255 and sumsq <= N*255^2: far inside int64 for any dataset
    s1 = np.zeros(c, np.int64)
    s2 = np.zeros(c, np.int64)
    flat = x.reshape(-1, c)
    step = max(1, (1 << 24) // max(c, 1))  # ~16M pixels per chunk
    for i in range(0, flat.shape[0], step):
        chunk = flat[i : i + step].astype(np.int64)
        s1 += chunk.sum(axis=0)
        s2 += np.square(chunk).sum(axis=0)
    mean = s1 / (255.0 * n)
    var = (s2 / (255.0 * 255.0) - n * mean * mean) / max(n - 1, 1)
    return mean, np.sqrt(np.maximum(var, 0.0))


class BatchLoader:
    """Shuffling fixed-shape batch iterator over a materialised array or
    a device-resident tensor (batches are then gathered on the device).
    Under a profiler each batch's work is a ``loader.batch`` span
    (``utils.span``), and the upload of its indices to the device counts
    in ``h2d_copies``."""

    def __init__(
        self,
        images: Images,
        labels: Optional[np.ndarray],
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        pad_final: bool = True,
        drop_last: bool = False,
    ):
        self.images = images
        self.labels = labels
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.pad_final = pad_final
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.images)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    @property
    def num_samples(self) -> int:
        return len(self.images)

    def __iter__(self) -> Iterator[Batch]:
        n = len(self.images)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        B = self.batch_size
        on_device = isinstance(self.images, torch.Tensor)
        for b in range(len(self)):
            # the span closes before the yield: the consumer's work is not the loader's
            with span("loader.batch", self.images.device if on_device else None):
                idx = order[b * B : (b + 1) * B]
                if on_device:
                    count_h2d()
                    imgs = self.images[torch.from_numpy(idx).to(self.images.device)]
                else:
                    imgs = self.images[idx]
                labs = self.labels[idx] if self.labels is not None else None
                mask = np.ones(len(idx), np.float32)
                if len(idx) < B and self.pad_final:
                    pad = B - len(idx)
                    if on_device:
                        imgs = torch.cat([imgs, imgs.new_zeros((pad, *imgs.shape[1:]))])
                    else:
                        imgs = np.concatenate([imgs, np.zeros((pad, *imgs.shape[1:]),
                                                              imgs.dtype)])
                    if labs is not None:
                        labs = np.concatenate([labs, np.zeros(pad, labs.dtype)])
                    mask = np.concatenate([mask, np.zeros(pad, np.float32)])
            yield Batch(imgs, labs, mask)
