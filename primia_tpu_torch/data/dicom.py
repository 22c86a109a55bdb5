"""Minimal self-contained DICOM decoder for X-ray images.

A copy of ``primia_tpu/data/dicom.py`` (pure numpy), kept so that the
port imports nothing of the JAX package.

The reference loads DICOMs through tensorflow-io's decode_dicom_image and
optionally applies a percentile contrast stretch
(``torchlib/dicomtools.py:34-133``). Neither tensorflow-io nor pydicom is
available here, so this module implements the small subset of the DICOM
standard needed for chest X-rays from scratch:

* Part-10 files (128-byte preamble + ``DICM``) and bare data sets.
* Explicit and implicit VR, little endian transfer syntaxes
  (1.2.840.10008.1.2, .1, and .1.99 deflated).
* Uncompressed ``PixelData`` with 8/16-bit MONOCHROME1/MONOCHROME2/RGB,
  1 or multiple frames (first frame is used), signed or unsigned.
* ``RescaleSlope``/``RescaleIntercept`` and MONOCHROME1 inversion.

The output contract mirrors ``load_dcm(..., scale="auto", dtype=uint8)``:
a uint8 array scaled from the stored-bit range, with optional percentile
contrast stretching (``enhance=True`` -> clip at [perc_lo, perc_hi] and
rescale to [0, 255], the skimage ``rescale_intensity`` behavior).
Compressed syntaxes (JPEG et al.) are rejected with a clear error.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, Tuple, Union

import numpy as np

# Transfer syntaxes we can decode (all little-endian, uncompressed).
IMPLICIT_VR_LE = "1.2.840.10008.1.2"
EXPLICIT_VR_LE = "1.2.840.10008.1.2.1"
DEFLATED_EXPLICIT_VR_LE = "1.2.840.10008.1.2.1.99"

# VRs whose explicit form uses a 2-byte reserved field + 4-byte length.
_LONG_VRS = {b"OB", b"OW", b"OF", b"OL", b"OD", b"SQ", b"UC", b"UR", b"UT", b"UN"}

_TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
_TAG_PIXEL_DATA = (0x7FE0, 0x0010)

# Attributes needed to interpret PixelData.
_WANTED = {
    (0x0028, 0x0002): "SamplesPerPixel",
    (0x0028, 0x0004): "PhotometricInterpretation",
    (0x0028, 0x0006): "PlanarConfiguration",
    (0x0028, 0x0008): "NumberOfFrames",
    (0x0028, 0x0010): "Rows",
    (0x0028, 0x0011): "Columns",
    (0x0028, 0x0100): "BitsAllocated",
    (0x0028, 0x0101): "BitsStored",
    (0x0028, 0x0103): "PixelRepresentation",
    (0x0028, 0x1052): "RescaleIntercept",
    (0x0028, 0x1053): "RescaleSlope",
}


class DicomError(ValueError):
    pass


def _parse_elements(buf: bytes, explicit: bool, wanted: Dict[str, object]):
    """Walk data elements; fill `wanted`; return raw PixelData bytes."""
    pos = 0
    n = len(buf)
    pixel_data = None
    while pos + 8 <= n:
        group, elem = struct.unpack_from("<HH", buf, pos)
        tag = (group, elem)
        pos += 4
        if explicit and group != 0xFFFE:
            vr = buf[pos : pos + 2]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
            else:
                length = struct.unpack_from("<H", buf, pos + 2)[0]
                pos += 4
        else:
            vr = b"UN"
            length = struct.unpack_from("<I", buf, pos)[0]
            pos += 4

        if tag == _TAG_PIXEL_DATA:
            if length == 0xFFFFFFFF:
                raise DicomError(
                    "encapsulated (compressed) PixelData is not supported; "
                    "transcode to an uncompressed little-endian syntax"
                )
            pixel_data = buf[pos : pos + length]
            pos += length
            continue

        if length == 0xFFFFFFFF or vr == b"SQ":
            # Sequence with undefined (or defined) length: skip item-wise.
            if length != 0xFFFFFFFF:
                pos += length
                continue
            depth = 1
            while pos + 8 <= n and depth > 0:
                g2, e2 = struct.unpack_from("<HH", buf, pos)
                ln2 = struct.unpack_from("<I", buf, pos + 4)[0]
                pos += 8
                if (g2, e2) == (0xFFFE, 0xE0DD):  # sequence delimiter
                    depth -= 1
                elif (g2, e2) == (0xFFFE, 0xE000) and ln2 != 0xFFFFFFFF:
                    pos += ln2
            continue

        value = buf[pos : pos + length]
        pos += length
        name = _WANTED.get(tag)
        if name is not None:
            wanted[name] = _decode_value(name, vr, value, explicit)
    return pixel_data


def _decode_value(name: str, vr: bytes, value: bytes, explicit: bool):
    if name in ("Rows", "Columns", "BitsAllocated", "BitsStored",
                "PixelRepresentation", "SamplesPerPixel", "PlanarConfiguration"):
        if explicit and vr == b"US" or (not explicit and len(value) == 2):
            return struct.unpack("<H", value[:2])[0]
        if len(value) >= 2:
            return struct.unpack("<H", value[:2])[0]
        return None
    text = value.decode("ascii", "ignore").strip("\x00 ")
    if name in ("RescaleIntercept", "RescaleSlope", "NumberOfFrames"):
        try:
            return float(text)
        except ValueError:
            return None
    return text


def read_dicom(path: Union[str, Path]) -> Tuple[np.ndarray, Dict[str, object]]:
    """Parse a DICOM file -> (raw pixel array [H, W] or [H, W, S], attrs).

    The array keeps the stored dtype (uint8/uint16/int16); rescale slope /
    intercept and photometric inversion are NOT applied here.
    """
    raw = Path(path).read_bytes()
    attrs: Dict[str, object] = {}

    if len(raw) > 132 and raw[128:132] == b"DICM":
        # File meta group is always explicit VR little endian.
        pos = 132
        meta_end = len(raw)
        # Parse group 0002 elements to find its length + transfer syntax.
        transfer = EXPLICIT_VR_LE
        while pos + 8 <= len(raw):
            group, elem = struct.unpack_from("<HH", raw, pos)
            if group != 0x0002:
                meta_end = pos
                break
            vr = raw[pos + 4 : pos + 6]
            if vr in _LONG_VRS:
                length = struct.unpack_from("<I", raw, pos + 8)[0]
                vpos = pos + 12
            else:
                length = struct.unpack_from("<H", raw, pos + 6)[0]
                vpos = pos + 8
            if (group, elem) == _TAG_TRANSFER_SYNTAX:
                transfer = raw[vpos : vpos + length].decode("ascii").strip("\x00 ")
            pos = vpos + length
            meta_end = pos
        body = raw[meta_end:]
        if transfer == DEFLATED_EXPLICIT_VR_LE:
            body = zlib.decompress(body, -zlib.MAX_WBITS)
            explicit = True
        elif transfer == IMPLICIT_VR_LE:
            explicit = False
        elif transfer == EXPLICIT_VR_LE:
            explicit = True
        else:
            raise DicomError(
                f"unsupported transfer syntax {transfer!r} in {path}; only "
                "uncompressed little-endian DICOMs are supported"
            )
    else:
        # Bare dataset without preamble; sniff explicitness from the first VR.
        body = raw
        explicit = raw[4:6].isalpha() and raw[4:6].isupper()

    pixels = _parse_elements(body, explicit, attrs)
    if pixels is None:
        raise DicomError(f"no PixelData element found in {path}")

    rows = int(attrs.get("Rows") or 0)
    cols = int(attrs.get("Columns") or 0)
    if not rows or not cols:
        raise DicomError(f"missing Rows/Columns in {path}")
    bits_alloc = int(attrs.get("BitsAllocated") or 16)
    samples = int(attrs.get("SamplesPerPixel") or 1)
    signed = int(attrs.get("PixelRepresentation") or 0) == 1

    if bits_alloc == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits_alloc == 16:
        dtype = np.int16 if signed else np.uint16
    else:
        raise DicomError(f"unsupported BitsAllocated={bits_alloc} in {path}")

    frame_px = rows * cols * samples
    arr = np.frombuffer(pixels, dtype=np.dtype(dtype).newbyteorder("<"))
    if arr.size < frame_px:
        raise DicomError(f"truncated PixelData in {path}")
    arr = arr[:frame_px]  # first frame only (X-rays are single-frame)
    if samples > 1:
        planar = int(attrs.get("PlanarConfiguration") or 0)
        if planar == 1:
            arr = arr.reshape(samples, rows, cols).transpose(1, 2, 0)
        else:
            arr = arr.reshape(rows, cols, samples)
    else:
        arr = arr.reshape(rows, cols)
    return arr.astype(dtype, copy=True), attrs


def load_dcm(
    path: Union[str, Path],
    *,
    enhance: bool = False,
    perc_lo: float = 2,
    perc_hi: float = 98,
) -> np.ndarray:
    """DICOM -> uint8 array, mirroring the reference ``load_dcm`` contract
    (``torchlib/dicomtools.py:34-78``: tfio auto-scale to uint8, then an
    optional percentile contrast stretch)."""
    arr, attrs = read_dicom(path)
    slope = attrs.get("RescaleSlope")
    intercept = attrs.get("RescaleIntercept")
    vals = arr.astype(np.float32)
    if slope is not None or intercept is not None:
        vals = vals * float(slope or 1.0) + float(intercept or 0.0)

    bits_stored = int(attrs.get("BitsStored") or arr.dtype.itemsize * 8)
    photometric = str(attrs.get("PhotometricInterpretation") or "MONOCHROME2")

    # tfio scale="auto": map the representable input range onto [0, 255].
    # Use the stored-bit range (12-bit X-rays in 16-bit containers would
    # otherwise come out 16x too dark).
    if np.issubdtype(arr.dtype, np.signedinteger):
        lo, hi = -(2 ** (bits_stored - 1)), 2 ** (bits_stored - 1) - 1
    else:
        lo, hi = 0, 2 ** bits_stored - 1
    if slope is not None or intercept is not None:
        lo = lo * float(slope or 1.0) + float(intercept or 0.0)
        hi = hi * float(slope or 1.0) + float(intercept or 0.0)
    u8 = np.clip((vals - lo) / max(hi - lo, 1e-9) * 255.0, 0, 255)

    if photometric.startswith("MONOCHROME1"):
        u8 = 255.0 - u8
    u8 = (u8 + 0.5).astype(np.uint8)

    if enhance:
        p_lo, p_hi = np.percentile(u8, (perc_lo, perc_hi))
        u8 = np.clip(
            (u8.astype(np.float32) - p_lo) / max(p_hi - p_lo, 1e-9) * 255.0,
            0, 255,
        ).astype(np.uint8)
    return u8


class DicomLoader:
    """Path -> HWC uint8 array with 1 or 3 channels (reference
    ``DicomLoader``, ``torchlib/dicomtools.py:105-133``)."""

    def __init__(self, out_channels: int = 3, **load_kwargs):
        if out_channels not in (1, 3):
            raise KeyError("out_channels must be 1 or 3")
        self.out_channels = out_channels
        self.load_kwargs = load_kwargs

    def __call__(self, path: Union[str, Path]) -> np.ndarray:
        arr = load_dcm(path, **self.load_kwargs)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if arr.shape[-1] == self.out_channels:
            return arr
        if self.out_channels == 1:
            # ITU-R 601 luma, matching PIL .convert("L")
            g = (arr[..., 0] * 299 + arr[..., 1] * 587 + arr[..., 2] * 114) // 1000
            return g.astype(np.uint8)[:, :, None]
        return np.repeat(arr, 3, axis=-1)


def write_dicom(
    path: Union[str, Path],
    array: np.ndarray,
    photometric: str = "MONOCHROME2",
) -> None:
    """Write a minimal explicit-VR-LE Part-10 DICOM (test fixture helper)."""
    array = np.ascontiguousarray(array)
    if array.ndim == 2:
        samples = 1
    else:
        samples = array.shape[-1]
    rows, cols = array.shape[:2]
    bits = array.dtype.itemsize * 8
    signed = 1 if np.issubdtype(array.dtype, np.signedinteger) else 0

    def elem(group, el, vr, value: bytes) -> bytes:
        if len(value) % 2:
            value += b"\x00"
        head = struct.pack("<HH", group, el)
        if vr in _LONG_VRS:
            return head + vr + b"\x00\x00" + struct.pack("<I", len(value)) + value
        return head + vr + struct.pack("<H", len(value)) + value

    def us(v):
        return struct.pack("<H", v)

    meta = b"".join([
        elem(0x0002, 0x0010, b"UI", EXPLICIT_VR_LE.encode()),
    ])
    body = b"".join([
        elem(0x0028, 0x0002, b"US", us(samples)),
        elem(0x0028, 0x0004, b"CS", photometric.encode()),
        elem(0x0028, 0x0010, b"US", us(rows)),
        elem(0x0028, 0x0011, b"US", us(cols)),
        elem(0x0028, 0x0100, b"US", us(bits)),
        elem(0x0028, 0x0101, b"US", us(bits)),
        elem(0x0028, 0x0103, b"US", us(signed)),
        elem(0x7FE0, 0x0010, b"OW", array.tobytes()),
    ])
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM")
        f.write(elem(0x0002, 0x0000, b"UL", struct.pack("<I", len(meta))))
        f.write(meta)
        f.write(body)
