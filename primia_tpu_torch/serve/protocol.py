"""Wire protocol: msgpack + zlib frames with first-class ndarrays.

Port of ``primia_tpu/serve/protocol.py``, a copy: the wire format is
unchanged, so a frame this module packs is byte for byte the JAX
package's frame of the same message, and each package reads the other's.
Messages are msgpack maps; numpy arrays travel as ``{b"__nd__": 1, dtype,
shape, data}``; a frame starts with a 1-byte compression header (``Z``
zlib at level 6 above 4 KiB, ``N`` none).
"""

from __future__ import annotations

import zlib
from typing import Any

import msgpack
import numpy as np

_COMPRESS_THRESHOLD = 1 << 12
_ZLIB = b"Z"
_NONE = b"N"


def _default(obj):
    if isinstance(obj, np.ndarray):
        return {
            b"__nd__": 1,
            b"dtype": obj.dtype.str,
            b"shape": list(obj.shape),
            b"data": obj.tobytes(),
        }
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _object_hook(obj):
    if obj.get(b"__nd__") or obj.get("__nd__"):
        g = lambda k: obj.get(k.encode()) if (k.encode() in obj) else obj.get(k)
        arr = np.frombuffer(g("data"), dtype=np.dtype(g("dtype")))
        return arr.reshape(g("shape")).copy()
    return obj


def pack(msg: Any) -> bytes:
    raw = msgpack.packb(msg, default=_default, use_bin_type=True)
    if len(raw) > _COMPRESS_THRESHOLD:
        return _ZLIB + zlib.compress(raw, 6)
    return _NONE + raw


def unpack(frame: bytes) -> Any:
    head, body = frame[:1], frame[1:]
    if head == _ZLIB:
        body = zlib.decompress(body)
    elif head != _NONE:
        raise ValueError(f"unknown compression header {head!r}")
    return msgpack.unpackb(body, object_hook=_object_hook, raw=False,
                           strict_map_key=False)
