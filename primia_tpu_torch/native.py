"""ctypes bindings for the native host-runtime library.

Port of ``primia_tpu/native.py`` over the same C++ source,
``native/src/primia_native.cpp``: a SHA-256-CTR keystream, the fused
fixed-point encode + two-party share split (a grid node's outbound share
stream, ``serve/node.py:_get_data_shares``), DICOM percentile windowing
and a batched uint8 bilinear resize (MNIST above 28 px,
``data/mnist.py:resize_to``). This is host code, not a device kernel.

The library is compiled at first use with the flags of ``native/Makefile``
(``$CXX`` or g++, ``-O3 -march=native -fPIC -std=c++17``, OpenMP when the
compiler can link it) into
``build/primia_tpu_torch/libprimia_native-<hash>.so`` at the root of the
checkout; the hash covers the source and the flags. Under a lock, so
nodes started together build it once. ``PRIMIA_NO_NATIVE`` set,
or no compiler, selects the numpy paths, which give the same results as
the JAX package's numpy paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[1]
SOURCE = _ROOT / "native" / "src" / "primia_native.cpp"
BUILD_DIR = _ROOT / "build" / "primia_tpu_torch"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDFLAGS = ("-shared",)
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _compiler() -> Optional[str]:
    return shutil.which(os.environ.get("CXX", "g++"))


def library_path(flags: Tuple[str, ...]) -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"libprimia_native-{h.hexdigest()[:16]}.so"


def _build() -> Optional[Path]:
    """The library, with OpenMP when the compiler can link it, else serial
    (the Makefile's fallback; its probe only preprocesses, and a compiler
    can take ``-fopenmp`` there yet lack ``libgomp`` to link). Warns with
    the compiler's message when neither builds."""
    cxx = _compiler()
    if cxx is None or not SOURCE.is_file():
        return None
    error = ""
    for omp in (("-fopenmp",), ()):
        flags = CXXFLAGS + omp + LDFLAGS
        out = library_path(flags)
        if out.is_file():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)], check=True,
                           capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
            os.replace(tmp, out)
            return out
        except subprocess.CalledProcessError as e:
            error = e.stderr.strip()
        except (OSError, subprocess.SubprocessError) as e:
            error = str(e)
        tmp.unlink(missing_ok=True)
    warnings.warn(f"native library not built with {cxx} ({error}); using the numpy paths")
    return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("PRIMIA_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u16p = ctypes.POINTER(ctypes.c_uint16)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.sha256_keystream.argtypes = [u8p, ctypes.c_uint64, u8p]
        lib.encode_and_share_f32.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, u8p, i64p, i64p,
        ]
        lib.percentile_stretch_u16.argtypes = [
            u16p, ctypes.c_int64, ctypes.c_double, ctypes.c_double, u8p,
        ]
        lib.resize_bilinear_u8.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, u8p,
        ]
        lib.primia_native_abi_version.restype = ctypes.c_int
        if lib.primia_native_abi_version() != 1:
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _seed32(seed) -> np.ndarray:
    """Any int / bytes -> 32-byte seed array."""
    if isinstance(seed, (bytes, bytearray)):
        b = bytes(seed)[:32].ljust(32, b"\0")
    else:
        b = int(seed).to_bytes(16, "little", signed=False).ljust(32, b"\0")
    return np.frombuffer(b, np.uint8).copy()


def sha256_keystream(seed, nbytes: int) -> np.ndarray:
    lib = _load()
    s = _seed32(seed)
    if lib is None:
        out = bytearray()
        ctr = 0
        base = bytes(s)
        while len(out) < nbytes:
            out += hashlib.sha256(base + ctr.to_bytes(8, "big")).digest()
            ctr += 1
        return np.frombuffer(bytes(out[:nbytes]), np.uint8)
    out = np.empty(nbytes, np.uint8)
    lib.sha256_keystream(_ptr(s, ctypes.c_uint8), nbytes, _ptr(out, ctypes.c_uint8))
    return out


def encode_and_share(x: np.ndarray, frac_bits: int, seed) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-point encode (scale 2^frac_bits) + 2-party additive split.

    Deterministic in ``seed``; reconstruction == encode(x) mod 2^64.
    """
    xf = np.ascontiguousarray(x, np.float32)
    n = xf.size
    lib = _load()
    if lib is None:
        ks = sha256_keystream(seed, max(n, 1) * 8)
        r = np.frombuffer(ks.tobytes()[: n * 8], np.uint64).astype(np.int64)
        enc = np.round(xf.reshape(-1).astype(np.float64) * (1 << frac_bits)).astype(
            np.int64
        )
        s0 = r
        s1 = (enc.view(np.uint64) - r.view(np.uint64)).view(np.int64)
        return s0.reshape(x.shape), s1.reshape(x.shape)
    s = _seed32(seed)
    s0 = np.empty(n, np.int64)
    s1 = np.empty(n, np.int64)
    lib.encode_and_share_f32(
        _ptr(xf.reshape(-1), ctypes.c_float), n, frac_bits,
        _ptr(s, ctypes.c_uint8), _ptr(s0, ctypes.c_int64), _ptr(s1, ctypes.c_int64),
    )
    return s0.reshape(x.shape), s1.reshape(x.shape)


def percentile_stretch(img_u16: np.ndarray, lo: float = 5.0, hi: float = 95.0) -> np.ndarray:
    """u16 image -> u8 with [lo, hi]-percentile contrast windowing."""
    a = np.ascontiguousarray(img_u16, np.uint16)
    lib = _load()
    if lib is None:
        lo_v, hi_v = np.percentile(a, [lo, hi])
        t = np.clip((a.astype(np.float64) - lo_v) / max(hi_v - lo_v, 1.0), 0, 1)
        return (t * 255.0 + 0.5).astype(np.uint8)
    out = np.empty(a.shape, np.uint8)
    lib.percentile_stretch_u16(
        _ptr(a.reshape(-1), ctypes.c_uint16), a.size, lo, hi,
        _ptr(out.reshape(-1), ctypes.c_uint8),
    )
    return out


def resize_bilinear(imgs_u8: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """(N,H,W,C) u8 batch -> (N,oh,ow,C) u8, bilinear."""
    a = np.ascontiguousarray(imgs_u8, np.uint8)
    n, h, w, c = a.shape
    lib = _load()
    if lib is None:
        from PIL import Image

        out = np.empty((n, oh, ow, c), np.uint8)
        for i in range(n):
            im = Image.fromarray(a[i] if c == 3 else a[i, :, :, 0])
            im = im.resize((ow, oh), Image.BILINEAR)
            r = np.asarray(im, np.uint8)
            out[i] = r if c == 3 else r[:, :, None]
        return out
    out = np.empty((n, oh, ow, c), np.uint8)
    lib.resize_bilinear_u8(
        _ptr(a, ctypes.c_uint8), n, h, w, c, oh, ow, _ptr(out, ctypes.c_uint8)
    )
    return out
