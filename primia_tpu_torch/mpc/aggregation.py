"""Secure (MPC) federated averaging — workload "federated_secure".

Port of ``primia_tpu/mpc/aggregation.py`` (reference
``torchlib/utils.py:1000-1105`` ``aggregation``): for every leaf of a
node-stacked tree (leading node axis), each node's value times its weight
is computed in float64, fixed-point encoded into the ring, split into two
party shares, summed over the node axis in share space, revealed and
decoded. Count leaves (``num_batches_tracked``, the JAX ``count``) pass
through from node 0 and are never encoded.

Trees are nested dicts and lists of tensors, named as the JAX package's
(``nn/jax_params.py:to_jax_tree``); a leaf's path is the tuple of its
dict keys and list indices. The reveal is the ring sum of the nodes'
encodings, whatever the shares, so it is bit-equal to the JAX package's
on every device. The shares come from a ``torch.Generator`` on the
leaf's device, seeded from the caller's key (a tuple of integers, such
as ``(seed, 777, round)``) and the leaf's CRC-32 key: the JAX package's
``fold_in(key, _leaf_key(path))``. The work stays on the leaf's device:
no host round-trip.

``party_devices`` (the JAX package's ``party_sharding``): each party's
shares go to its own device, each party sums its own over the nodes, and
the reveal is the one opening, on the leaf's device. Bit for bit the
unsplit result.
"""

from __future__ import annotations

import zlib
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.ops.numerics import div

Path = Tuple[Any, ...]


def _keystr(path: Path) -> str:
    """The path as ``jax.tree_util.keystr`` writes it: ``['a'][0]['w']``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def _leaf_key(path: Path) -> int:
    """Stable per-leaf stream value: a CRC-32 of the leaf's key string.

    Python's string ``hash`` is salted per process, so it would draw
    different shares across runs even with a fixed seed (breaking the
    reference's deterministic-seed contract, ``train.py:63-68``)."""
    return zlib.crc32(_keystr(path).encode("utf-8"))


def _is_count_leaf(path: Path) -> bool:
    """BN batch counters are excluded from aggregation (reference skips
    ``num_batches_tracked``, ``utils.py:1049``)."""
    return any(k == "count" for k in path if isinstance(k, str))


def map_with_path(fn: Callable[[Path, torch.Tensor], Any], tree, path: Path = ()):
    """``jax.tree_util.tree_map_with_path`` over nested dicts, lists and
    tuples of tensors."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def node_weights(weights, device) -> torch.Tensor:
    """(N_nodes,) float64 weights on ``device``. From the host they go up
    pinned and non-blocking: a copy from pageable memory waits for all the
    work queued on the stream."""
    if isinstance(weights, torch.Tensor):
        return weights.to(device=device, dtype=torch.float64)
    w = torch.from_numpy(np.array(weights, np.float64))
    if torch.device(device).type == "cuda":
        return w.pin_memory().to(device, non_blocking=True)
    return w


def _node_weights(weights, leaf: torch.Tensor) -> torch.Tensor:
    return node_weights(weights, leaf.device).reshape((-1,) + (1,) * (leaf.dim() - 1))


def secure_fedavg_leaf(key: Sequence[int], path: Path, leaf: torch.Tensor, weights,
                       frac_bits: int = fixed.DEFAULT_FRAC_BITS,
                       party_devices=None) -> torch.Tensor:
    """One leaf of :func:`secure_fedavg`: ``leaf`` is ``(N_nodes, ...)``,
    ``weights`` (N_nodes,) floats or, to spare a copy a leaf, the tensor
    :func:`node_weights` gives on the leaf's device."""
    if _is_count_leaf(path):
        return leaf[0]
    ring = fixed.encode(leaf.double() * _node_weights(weights, leaf), frac_bits)
    shared = S.share(S.stream(leaf.device, *key, _leaf_key(path)), ring)
    parties = S.party_devices_of(party_devices)
    if parties is not None:
        shared = S.AShare(S.split(shared.data, parties, leaf.device))
    revealed = S.reconstruct(AShareSumNodes(shared))
    return fixed.decode(revealed, frac_bits).to(leaf.dtype)


def secure_fedavg(key: Sequence[int], stacked_tree, weights,
                  frac_bits: int = fixed.DEFAULT_FRAC_BITS, party_devices=None):
    """Weighted average of node-stacked trees via MPC share-sum.

    ``stacked_tree``: tree with leaves (N_nodes, ...); ``weights``:
    (N_nodes,) floats summing to 1; ``key``: the integers the shares'
    streams are seeded from; ``party_devices``: a pair of devices for the
    two parties' shares (the module's note). Returns the aggregated
    (unstacked) tree. Count leaves pass through from node 0."""
    return map_with_path(
        lambda path, leaf: secure_fedavg_leaf(key, path, leaf, weights, frac_bits,
                                              party_devices),
        stacked_tree)


def AShareSumNodes(sh: S.AShare) -> S.AShare:
    """Sum a sharing over its first value axis (the node axis) — the
    share-space federated reduce."""
    return S.AShare(sh.data.sum(1))


def plain_fedavg_leaf(path: Path, leaf: torch.Tensor, weights) -> torch.Tensor:
    """One leaf of :func:`plain_fedavg`."""
    if _is_count_leaf(path):
        return leaf[0]
    return (leaf.double() * _node_weights(weights, leaf)).sum(0).to(leaf.dtype)


def plain_fedavg(stacked_tree, weights):
    """Unencrypted weighted average (``--unencrypted_aggregation``;
    reference ``federated_avg``, ``syft/frameworks/torch/fl/utils.py:32``)."""
    return map_with_path(lambda path, leaf: plain_fedavg_leaf(path, leaf, weights),
                         stacked_tree)


def fedavg_leaf(key: Optional[Sequence[int]], path: Path, leaf: torch.Tensor, weights,
                frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> torch.Tensor:
    """One leaf of the federated average: plain FedAvg when ``key`` is
    None (``--unencrypted_aggregation``), else secure aggregation with
    shares seeded from ``key``."""
    if key is None:
        return plain_fedavg_leaf(path, leaf, weights)
    return secure_fedavg_leaf(key, path, leaf, weights, frac_bits)


def secure_average_stats(key: Sequence[int], per_node_values,
                         frac_bits: int = fixed.DEFAULT_FRAC_BITS,
                         device="cpu") -> torch.Tensor:
    """Securely average per-node statistics vectors (the mean/std
    averaging of ``setup_pysyft``, ``utils.py:764-791``: share each
    node's value, sum in share space, reveal, divide by N). Float32 on
    ``device``."""
    stacked = torch.stack([torch.as_tensor(np.asarray(v, np.float64), device=device)
                           for v in per_node_values])
    n = stacked.shape[0]
    shared = S.share(S.stream(stacked.device, *key), fixed.encode(stacked, frac_bits))
    summed = AShareSumNodes(shared)
    return div(fixed.decode(S.reconstruct(summed), frac_bits), float(n)).float()
