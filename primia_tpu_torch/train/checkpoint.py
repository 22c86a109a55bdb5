"""Checkpoint save/load, in the JAX package's npz format.

Port of ``primia_tpu/train/checkpoint.py``: a checkpoint written by either
package loads in the other. Model weights are stored as the JAX
package's ``(params, state)`` trees, converted from and to the port's
modules by ``nn/jax_params.py``.

Reference contract (``torchlib/utils.py:1470-1493`` ``save_model``,
``train.py:344-389`` resume, ``inference.py:82-93`` restore): a single
checkpoint file holding ``{epoch, model_state_dict, optim_state_dict
(per-worker dict when federated), args, val_mean_std}``; ``val_mean_std``
is the normalization contract between training and inference.

Format: a numpy ``.npz`` archive (no pickling) — pytrees are flattened
with a JSON structure skeleton and the leaves stored as arrays. Dicts,
lists, tuples, the optimizer NamedTuples, scalars, and None round-trip
without needing a template at load time.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np

from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn.jax_params import to_jax_tree


# The optimizer states of the JAX package (``primia_tpu/train/optim.py``),
# by the names and fields its checkpoints record in their "nt" nodes.
class AdamState(NamedTuple):
    step: Any
    mu: Any
    nu: Any


class SGDState(NamedTuple):
    step: Any
    momentum: Any


_NAMEDTUPLES = {"AdamState": AdamState, "SGDState": SGDState}


def _encode(obj, leaves: list):
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, dict):
        return {"t": "dict", "v": {k: _encode(obj[k], leaves) for k in obj}}
    for name, cls in _NAMEDTUPLES.items():
        if isinstance(obj, cls):
            return {"t": "nt", "c": name,
                    "v": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode(x, leaves) for x in obj]}
    if isinstance(obj, (str,)):
        return {"t": "str", "v": obj}
    if isinstance(obj, bool):
        return {"t": "bool", "v": obj}
    if isinstance(obj, int):
        return {"t": "int", "v": obj}
    if isinstance(obj, float):
        return {"t": "float", "v": obj}
    # array leaf (jax or numpy, incl. 0-d)
    leaves.append(np.asarray(obj))
    return {"t": "arr", "i": len(leaves) - 1}


def _decode(spec, leaves):
    t = spec["t"]
    if t == "none":
        return None
    if t == "dict":
        return {k: _decode(v, leaves) for k, v in spec["v"].items()}
    if t == "nt":
        cls = _NAMEDTUPLES[spec["c"]]
        return cls(*[_decode(x, leaves) for x in spec["v"]])
    if t == "list":
        return [_decode(x, leaves) for x in spec["v"]]
    if t == "tuple":
        return tuple(_decode(x, leaves) for x in spec["v"])
    if t in ("str", "bool", "int", "float"):
        return spec["v"]
    if t == "arr":
        return leaves[spec["i"]]
    raise ValueError(f"bad checkpoint spec node {t!r}")


def save_tree(path, tree: Dict[str, Any]) -> None:
    """Serialize an arbitrary pytree-of-arrays dict to ``path``."""
    leaves: list = []
    spec = _encode(tree, leaves)
    payload = {f"leaf_{i}": a for i, a in enumerate(leaves)}
    payload["__spec__"] = np.frombuffer(
        json.dumps(spec).encode(), dtype=np.uint8
    )
    path = Path(path)
    if path.parent and not path.parent.is_dir():
        path.parent.mkdir(parents=True, exist_ok=True)
    buf = io.BytesIO()
    # stored, not deflated: float parameters are incompressible noise
    # (zlib-6 costs ~6 s per ResNet checkpoint to shave 7%)
    np.savez(buf, **payload)
    path.write_bytes(buf.getvalue())


def load_tree(path) -> Dict[str, Any]:
    with np.load(path, allow_pickle=False) as z:
        spec = json.loads(bytes(z["__spec__"].tobytes()).decode())
        leaves = {int(k.split("_")[1]): z[k] for k in z.files if k.startswith("leaf_")}
    return _decode(spec, [leaves[i] for i in range(len(leaves))])


def save_model(
    path,
    *,
    epoch: int,
    model,
    args: Arguments,
    val_mean_std: Tuple[np.ndarray, np.ndarray],
    opt_state: Optional[Any] = None,
) -> None:
    """Write a checkpoint of ``model`` (one of the port's modules) that
    both packages load: ``{epoch, args, val_mean_std, model_state_dict:
    {params, state}, optim_state_dict}`` with the weights in the JAX
    layout."""
    params, state = to_jax_tree(model)
    save_tree(path, {
        "epoch": int(epoch),
        "args": args.to_json(),
        "val_mean_std": (np.asarray(val_mean_std[0]), np.asarray(val_mean_std[1])),
        "model_state_dict": {"params": params, "state": state},
        "optim_state_dict": opt_state,
    })


def load_model(path) -> Dict[str, Any]:
    """Read a checkpoint; ``args`` comes back as an ``Arguments``."""
    tree = load_tree(path)
    tree["args"] = Arguments.from_json(tree["args"])
    return tree

