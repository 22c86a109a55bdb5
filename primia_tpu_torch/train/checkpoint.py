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

import csv
import io
import json
from concurrent.futures import Executor, Future, ThreadPoolExecutor
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

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


def snapshot(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` on its own device: what a checkpoint
    keeps of a tensor that training goes on changing in place."""
    return t.detach().clone(memory_format=torch.contiguous_format)


def _map_tensors(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    return tree


def _cuda_tensors(tree) -> list:
    found: list = []
    _map_tensors(lambda t: found.append(t) if t.is_cuda else None, tree)
    return found


def _to_host(tree, ready: Optional["torch.cuda.Event"]):
    """``tree`` with its tensors as numpy arrays. CUDA tensors are copied
    into pinned host memory on a side stream that first waits for
    ``ready`` (recorded after the snapshot), so the caller's stream and
    the rest of the card run on."""
    host = {}
    cuda = _cuda_tensors(tree)
    if cuda:
        stream = torch.cuda.Stream(device=cuda[0].device)
        stream.wait_event(ready)
        with torch.cuda.stream(stream):
            for t in cuda:
                host[id(t)] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True)
        stream.synchronize()
    return _map_tensors(lambda t: host.get(id(t), t).numpy(), tree)


def save_model(
    path,
    *,
    epoch: int,
    model,
    args: Arguments,
    val_mean_std: Tuple[np.ndarray, np.ndarray],
    opt_state: Optional[Any] = None,
    raw_model=None,
    executor: Optional[Executor] = None,
) -> Optional[Future]:
    """Write a checkpoint of ``model`` (one of the port's modules) that
    both packages load: ``{epoch, args, val_mean_std, model_state_dict:
    {params, state}, optim_state_dict}`` with the weights in the JAX
    layout. ``opt_state`` is the optimizer's ``state_to_jax()``
    (``train/optim.py``): ``AdamState``/``SGDState`` with the moments as
    one flat vector in the JAX parameter order (numpy, or with
    ``on_device=True`` a copy on the card); federated training saves
    ``{worker: state}``, one per node, as the JAX package does.
    ``raw_model``'s parameters go under the top-level key ``raw_params``:
    under DP with a parameter EMA, ``model`` is the average and
    ``raw_model`` the model the optimizer state belongs to. The JAX
    package's loader decodes the key and uses nothing of it.

    The caller pays for a copy of the weights on their device
    (:func:`snapshot`), which decouples the checkpoint from the next
    steps' in-place updates. With an ``executor`` the copy to the host
    and the write run there (the JAX package's ``fetch_and_write``) and
    the ``Future`` is returned: the caller must read its ``.result()``,
    or a failed write goes unseen. Without one they run before this
    returns. Both write the same bytes."""
    params, state = to_jax_tree(model, leaf=snapshot)
    tree = {
        "epoch": int(epoch),
        "args": args.to_json(),
        "val_mean_std": (np.asarray(val_mean_std[0]), np.asarray(val_mean_std[1])),
        "model_state_dict": {"params": params, "state": state},
        "optim_state_dict": opt_state,
    }
    if raw_model is not None:
        tree["raw_params"] = to_jax_tree(raw_model, leaf=snapshot)[0]
    cuda = _cuda_tensors(tree)
    ready = torch.cuda.current_stream(cuda[0].device).record_event() if cuda else None

    def fetch_and_write():
        save_tree(path, _to_host(tree, ready))

    if executor is not None:
        return executor.submit(fetch_and_write)
    fetch_and_write()
    return None


class BackgroundWriter:
    """The train loops' checkpoint writer: one thread, so writes land in
    order, and at most one save in flight, so device snapshots cannot pile
    up on the card (``primia_tpu/train/loop.py``'s ``submit_save``).
    Leaving the ``with`` block waits for every write, also when the block
    raises (``TrialPruned`` or any error); without an error it then
    raises the first failed write's error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._futures: list = []

    def save_model(self, path, **kw) -> None:
        if self._futures:
            self._futures[-1].result()
        self._futures.append(save_model(path, executor=self._pool, **kw))

    def __enter__(self) -> "BackgroundWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._pool.shutdown(wait=True)
        if exc_type is None:
            for f in self._futures:
                f.result()


def load_model(path) -> Dict[str, Any]:
    """Read a checkpoint; ``args`` comes back as an ``Arguments``."""
    tree = load_tree(path)
    tree["args"] = Arguments.from_json(tree["args"])
    return tree


def save_config_results(args: Arguments, score: float, timestamp: Optional[str] = None,
                        table: str = "") -> None:
    """Append the run's full config and best score as one row to the
    registry CSV ``args.save_file`` (reference ``save_config_results``,
    ``utils.py:859-874``). The columns are the union of the file's and
    the row's, as the JAX package's pandas concat gives them; written
    with the ``csv`` module, so it needs no pandas."""
    row = {k: ("" if v is None else v) for k, v in args.to_dict().items()}
    row["timestamp"] = timestamp or datetime.now().strftime("%d.%m.%Y %H:%M:%S")
    row["best_validation_score"] = score
    row["stats_table"] = table
    path = Path(args.save_file)
    path.parent.mkdir(parents=True, exist_ok=True)
    rows, fields = [], []
    if path.is_file():
        with path.open(newline="") as f:
            reader = csv.DictReader(f)
            fields = list(reader.fieldnames or [])
            rows = list(reader)
    fields += [k for k in row if k not in fields]
    rows.append(row)
    with path.open("w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, restval="")
        w.writeheader()
        w.writerows(rows)
