"""Multi-process runs on ``torch.distributed``, and the meshes of ranks.

Port of ``primia_tpu/parallel/multihost.py``. The JAX package joins the
processes of a TPU slice with ``jax.distributed`` and lays every device
of the slice on a mesh. Here one process is one rank, and a rank drives
one device (the JAX package counts devices per process). A mesh is a
grid of ranks, and each of its axes is the ``torch.distributed`` group of
the ranks that differ along it only.

Usage (the same script on every rank)::

    from primia_tpu_torch.parallel import multihost

    multihost.initialize()                  # no-op without a cluster
    mesh = multihost.federated_mesh(n_nodes=3)
    # mesh.group("node"): the ranks that hold this rank's data shard in
    # the other nodes; secure_fedavg below sums the node axis over it

Backends: ``nccl`` when every rank of the host has a card of its own,
``gloo`` otherwise. NCCL refuses two ranks on one GPU, so ranks that share
``cuda:0`` take gloo, which reduces CUDA tensors through the host and
gathers nothing on the card: :func:`all_gather` stages CUDA tensors
through the host under gloo.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.aggregation import _is_count_leaf, _leaf_key, map_with_path

log = logging.getLogger(__name__)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _local_size() -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else the world."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank() % _local_size()))


def choose_backend(device="cuda", local_size: int = 1) -> str:
    """``nccl`` when ``device`` is CUDA and the host has a card for each of
    its ``local_size`` ranks, else ``gloo``."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= local_size:
        return "nccl"
    return "gloo"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda") -> bool:
    """Join this process to the run through ``torch.distributed``.

    Returns True when a multi-process run was initialised (now or by an
    earlier call), False for the single-process case: without arguments
    and without torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``) it is a no-op. ``coordinator_address`` is
    ``host:port`` or a ``tcp://`` URL; with it, ``num_processes`` and
    ``process_id`` are required. ``device`` is the kind of device the
    ranks compute on (``"cpu"`` takes gloo). The backend chosen is logged
    and :func:`backend` returns it."""
    if dist.is_initialized():
        return True
    if coordinator_address is None:
        if not all(os.environ.get(k) for k in _ENV):
            return False
        url = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator address needs num_processes and "
                             "process_id")
        url = (coordinator_address if "://" in coordinator_address
               else f"tcp://{coordinator_address}")
        world, rank = num_processes, process_id
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    name = choose_backend(device, local)
    dist.init_process_group(name, init_method=url, world_size=world, rank=rank)
    log.info("multihost: rank %d of %d, backend %s", rank, world, name)
    return True


def backend() -> Optional[str]:
    """The initialised backend's name, or None in a single process."""
    return dist.get_backend() if dist.is_initialized() else None


def rank_device(device="cuda") -> torch.device:
    """This rank's device: under NCCL the card of its local rank; under
    gloo (ranks sharing a card, or the CPU) ``device`` itself, a card
    named by its index (``cuda:0`` for ``cuda``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", _local_rank() if backend() == "nccl" else 0)
    return device


def slice_topology() -> Tuple[int, int, int]:
    """(rank, world size, device count). One device a rank, so the count
    is the world size (the JAX package's is every device of the slice)."""
    if not dist.is_initialized():
        return 0, 1, 1
    return dist.get_rank(), dist.get_world_size(), dist.get_world_size()


def factor_mesh(n_devices: int, n_nodes: int) -> Tuple[int, int]:
    """Split ``n_devices`` into (node, data) axis sizes.

    The node axis carries the federated replicas; remaining parallelism
    goes to per-node batch data-parallelism. When the device count is
    not divisible by ``n_nodes``, node count falls back to the largest
    divisor <= n_nodes (nodes beyond the axis are masked by the
    federated loop, same as heterogeneous shards).
    """
    node_n = max(d for d in range(1, min(n_nodes, n_devices) + 1)
                 if n_devices % d == 0)
    return node_n, n_devices // node_n


class RankMesh:
    """A grid of ranks with named axes (the JAX ``Mesh`` of devices).

    ``devices`` is the (numpy) grid of ranks, ``shape`` the axis sizes by
    name. :meth:`group` is the process group of this rank's line along an
    axis (None in a single process), :meth:`index` its coordinate on it."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self._groups: Dict[str, object] = {}
        coord = np.argwhere(self.devices == self.rank)
        self._coord = tuple(int(c) for c in coord[0]) if len(coord) else None
        if self.size > 1:
            # every rank makes every group, in one order (new_group's rule)
            for ax, name in enumerate(self.axis_names):
                lines = np.moveaxis(self.devices, ax, -1).reshape(-1, self.devices.shape[ax])
                for line in lines:
                    g = dist.new_group([int(r) for r in line])
                    if self.rank in line:
                        self._groups[name] = g

    def group(self, axis: str):
        return self._groups.get(axis)

    def index(self, axis: str) -> int:
        return self._coord[self.axis_names.index(axis)] if self._coord else 0


def federated_mesh(n_nodes: int, devices=None) -> RankMesh:
    """A (node, data) mesh over every rank of the run (or the ranks
    ``devices``): :func:`factor_mesh` sizes it, the node axis carries the
    federated replicas and the data axis each node's data parallelism."""
    ranks = np.asarray(devices if devices is not None else
                       np.arange(dist.get_world_size() if dist.is_initialized() else 1))
    node_n, data_n = factor_mesh(ranks.size, n_nodes)
    return RankMesh(ranks.reshape(node_n, data_n), ("node", "data"))


# ------------------------------------------------------------- collectives

def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over the group's ranks (floats; integers only where
    the sum cannot wrap: see :func:`ring_sum`)."""
    dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """(ranks, *t.shape): every rank's ``t``, in rank order, on ``t``'s
    device. gloo gathers no CUDA tensor, so there they go through the
    host."""
    n = dist.get_world_size(group)
    staged = t.device.type == "cuda" and dist.get_backend(group) != "nccl"
    src = t.cpu() if staged else t.contiguous()
    out = torch.empty((n, *src.shape), dtype=src.dtype, device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(t.device, non_blocking=True) if staged else out


def ring_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum mod 2^64 of every rank's int64 ``t``: gathered, then added
    by torch, whose int64 addition wraps (a backend's reduction is not
    promised to)."""
    return all_gather(t, group).sum(0)


# --------------------------------------------------------- secure FedAvg

def secure_fedavg(key: Sequence[int], stacked_tree, weights, mesh: RankMesh,
                  frac_bits: int = fixed.DEFAULT_FRAC_BITS):
    """``mpc/aggregation.py:secure_fedavg`` with the node axis over the
    mesh's ``node`` ranks: ``stacked_tree`` holds this rank's nodes, the
    ``node``-th block of ``len(weights) / mesh.shape["node"]`` rows of the
    whole stack; ``weights`` covers every node. Each rank encodes and
    shares its rows (the share draws are the one-process draws' rows),
    sums them in share space, and the node ranks' partial share sums are
    added in the ring (:func:`ring_sum`), so every party's share sum and
    the reveal are bit for bit the one-process ones. Returns the
    aggregated tree on every rank; count leaves come from node 0."""
    w = np.asarray(weights, np.float64)
    n_nodes = w.size
    per = n_nodes // mesh.shape.get("node", 1)
    lo = mesh.index("node") * per
    group = mesh.group("node")

    def leaf_fn(path, leaf):
        if leaf.shape[0] != per:
            raise ValueError(f"{path}: {leaf.shape[0]} node rows on this rank, expected {per}")
        if _is_count_leaf(path):
            first = leaf[:1] if lo == 0 else torch.zeros_like(leaf[:1])
            return (first if group is None else all_gather(first, group).sum(0))[0]
        wl = torch.as_tensor(w[lo:lo + per], device=leaf.device)
        ring = fixed.encode(leaf.double() * wl.reshape((-1,) + (1,) * (leaf.dim() - 1)),
                            frac_bits)
        r = S.rand_ring(S.stream(leaf.device, *key, _leaf_key(path)),
                        (n_nodes, *leaf.shape[1:]))[lo:lo + per]
        partial = torch.stack([ring - r, r]).sum(1)  # (2, ...): each party's share sum
        summed = partial if group is None else ring_sum(partial, group)
        return fixed.decode(S.reconstruct(S.AShare(summed)), frac_bits).to(leaf.dtype)

    return map_with_path(leaf_fn, stacked_tree)
