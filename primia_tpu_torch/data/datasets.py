"""Host-side image ingest and dataset classes.

Port of ``primia_tpu/data/datasets.py`` (the serving path's part:
``CombinedLoader``, ``ImageFolderDataset``, ``PathDataset`` and the
materialize cache). Decode (PIL, or the DICOM parser in ``.dicom``) and
square resize to ``inference_resolution`` run once, in a thread pool,
into one contiguous uint8 ``(N, R, R, C)`` array; the predict step moves
batches of it to the device.

PIL is imported where a file needs it, so DICOM input at the target
resolution needs no image library.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from primia_tpu_torch.data.dicom import DicomLoader

PIL_EXTENSIONS = {
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
}
DICOM_EXTENSIONS = {".dcm", ".dicom"}


def pil_loader(path: Union[str, Path], channels: int = 3,
               target: Optional[int] = None) -> np.ndarray:
    """Decode an image file to HWC uint8 with the requested channel count.

    channels=3 mirrors torchvision's ``default_loader`` (RGB convert);
    channels=1 mirrors the reference ``single_channel_loader``
    (``torchlib/dataloader.py:247-253``).

    ``target`` is a downstream resize hint: when the source is at least
    2x larger, ``Image.draft`` lets libjpeg decode at a reduced DCT
    scale (>= 2x the target, so the subsequent bilinear resize still
    low-passes properly) — a ~2x single-core decode speedup on the
    chest X-ray set with no measurable pixel difference after resize.
    """
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f)
        if target is not None and min(img.size) >= 2 * target:
            img.draft(None, (2 * target, 2 * target))
        img = img.convert("RGB" if channels == 3 else "L")
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


class CombinedLoader:
    """Extension-dispatched decode: PIL formats + DICOM.

    Mirrors reference ``CombinedLoader`` (``torchlib/dataloader.py:55-135``).
    Output is HWC uint8 numpy.
    """

    def __init__(self, channels: int = 3):
        if channels not in (1, 3):
            raise RuntimeError("Only 1 or 3 channels supported yet.")
        self.channels = channels
        self.dicom = DicomLoader(channels)

    def __call__(self, path: Union[str, Path],
                 target: Optional[int] = None) -> np.ndarray:
        ext = os.path.splitext(str(path))[1].lower()
        if ext in PIL_EXTENSIONS:
            return pil_loader(path, self.channels, target=target)
        if ext in DICOM_EXTENSIONS:
            return self.dicom(path)
        raise RuntimeError(
            "file extension does not match specified supported extensions: "
            f"{ext}"
        )


def _resize_square(arr: np.ndarray, resolution: int) -> np.ndarray:
    """Square bilinear resize (albumentations ``Resize(R, R)`` analogue)."""
    h, w, c = arr.shape
    if h == resolution and w == resolution:
        return arr
    from PIL import Image

    img = Image.fromarray(arr if c == 3 else arr[:, :, 0])
    img = img.resize((resolution, resolution), Image.BILINEAR)
    out = np.asarray(img, dtype=np.uint8)
    if out.ndim == 2:
        out = out[:, :, None]
    return out


def _decode_many(
    paths: Sequence[Union[str, Path]],
    loader: Callable[[Union[str, Path]], np.ndarray],
    resolution: int,
    channels: int,
) -> np.ndarray:
    """Decode + resize a list of files in parallel into (N, R, R, C) uint8."""
    out = np.empty((len(paths), resolution, resolution, channels), np.uint8)

    def work(i):
        try:
            img = loader(paths[i], target=resolution)
        except TypeError:  # custom loaders without the resize hint
            img = loader(paths[i])
        out[i] = _resize_square(img, resolution)

    if len(paths) > 1:
        with ThreadPoolExecutor(max_workers=min(32, os.cpu_count() or 4)) as ex:
            list(ex.map(work, range(len(paths))))
    elif paths:
        work(0)
    return out


# ---------------------------------------------------------------------
# materialization cache: decoding thousands of JPEGs costs ~a minute of
# single-core time per run; the decoded uint8 stack is a pure function
# of (file paths, sizes, mtimes, resolution, channels), so it is cached
# on disk across processes. Disable with PRIMIA_MATERIALIZE_CACHE=0.

def _cache_path(paths, resolution: int, channels: int) -> Optional[Path]:
    if os.environ.get("PRIMIA_MATERIALIZE_CACHE", "1") == "0" or not paths:
        return None
    import hashlib

    h = hashlib.sha1(f"{resolution}:{channels}".encode())
    for p in paths:
        try:
            st = os.stat(p)
        except OSError:
            return None
        h.update(f"{p}:{st.st_size}:{st.st_mtime_ns}".encode())
    root = Path(os.environ.get("PRIMIA_CACHE_DIR",
                               Path.home() / ".cache" / "primia_tpu"))
    return root / "materialized" / f"{h.hexdigest()}.npy"


def _cache_load(paths, resolution: int, channels: int) -> Optional[np.ndarray]:
    cp = _cache_path(paths, resolution, channels)
    if cp is None or not cp.is_file():
        return None
    try:
        # memory-mapped: materialize returns instantly; pages fault in
        # lazily (e.g. during the one-time device upload)
        return np.load(cp, mmap_mode="r")
    except Exception:
        return None


def _cache_store(paths, resolution: int, channels: int, imgs: np.ndarray) -> None:
    cp = _cache_path(paths, resolution, channels)
    if cp is None:
        return
    try:
        cp.parent.mkdir(parents=True, exist_ok=True)
        tmp = cp.with_suffix(".tmp.npy")
        np.save(tmp, imgs)  # raw .npy: mmap-able, and pixels don't zlib
        os.replace(tmp, cp)
    except OSError:
        pass  # cache is best-effort (full disk, read-only home, ...)


class Dataset:
    """Minimal dataset protocol: paths + labels, materialized on demand."""

    paths: List[str]
    labels: Optional[np.ndarray]  # int32 (N,) or None
    classes: Optional[List[str]]
    channels: int = 3

    def __len__(self) -> int:
        return len(self.paths)

    def materialize(self, resolution: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        cached = _cache_load(self.paths, resolution, self.channels)
        if cached is not None:
            return cached, self.labels
        loader = CombinedLoader(self.channels)
        imgs = _decode_many(self.paths, loader, resolution, self.channels)
        _cache_store(self.paths, resolution, self.channels, imgs)
        return imgs, self.labels


class ImageFolderDataset(Dataset):
    """root/<class_name>/<image> layout, classes sorted alphabetically
    (torchvision ImageFolder contract, used throughout the reference)."""

    def __init__(self, root: Union[str, Path], channels: int = 3):
        root = Path(root)
        if not root.is_dir():
            raise FileNotFoundError(f"dataset root {root} does not exist")
        self.root = str(root)
        self.channels = channels
        exts = PIL_EXTENSIONS | DICOM_EXTENSIONS
        self.classes = sorted(
            d.name for d in root.iterdir() if d.is_dir() and not d.name.startswith(".")
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        paths, labels = [], []
        for cls in self.classes:
            for f in sorted((root / cls).iterdir()):
                if (
                    f.suffix.lower() in exts
                    and not f.name.startswith("._")
                    and f.is_file()
                ):
                    paths.append(str(f))
                    labels.append(self.class_to_idx[cls])
        self.paths = paths
        self.labels = np.asarray(labels, np.int32)


class PathDataset(Dataset):
    """Flat directory of images, unlabeled — the inference-data layout
    (reference ``PathDataset``, ``torchlib/dataloader.py:264-303``)."""

    def __init__(self, root: Union[str, Path], channels: int = 3):
        root = Path(root)
        exts = PIL_EXTENSIONS | DICOM_EXTENSIONS
        self.root = str(root)
        self.channels = channels
        self.classes = None
        self.labels = None
        self.paths = [
            str(f)
            for f in sorted(root.iterdir())
            if f.suffix.lower() in exts and not f.name.lower().startswith("._")
        ]

