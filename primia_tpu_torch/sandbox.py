"""Demo sandbox: an in-process grid with toy data, ready to play with.

Port of ``primia_tpu/sandbox.py`` (reference ``sy.create_sandbox()``,
``syft/sandbox.py``): alice, bob and charlie, each a port ``GridNode``
hosting a toy 3-class image set, plus a ``crypto_provider``:

>>> from primia_tpu_torch.sandbox import create_sandbox
>>> sb = create_sandbox(device="cpu")
>>> sb.grid.search("#traindata")
{'alice': ['#traindata'], 'bob': ['#traindata'], 'charlie': ['#traindata']}
>>> sb.close()

``serve=True`` also starts real NodeServers on localhost ports, so the
WebSocket and HTTP client paths can be exercised.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np


class _LocalClient:
    """An in-process stand-in for ``NodeClient``."""

    def __init__(self, node):
        self.id = node.id
        self._node = node

    def send(self, msg):
        return self._node.handle(msg)

    def get_obj(self, tag):
        return self._node.store[tag]

    def close(self):
        pass


@dataclass
class Sandbox:
    nodes: Dict[str, "object"]
    servers: List[object] = field(default_factory=list)
    clients: List[object] = field(default_factory=list)

    @property
    def grid(self):
        from primia_tpu_torch.serve.client import GridNetwork

        if self.clients:
            return GridNetwork(self.clients)
        return GridNetwork([_LocalClient(n) for n in self.nodes.values()])

    def close(self):
        for s in self.servers:
            s.stop()
        for c in self.clients:
            c.close()


def create_sandbox(worker_names=("alice", "bob", "charlie"),
                   n_per_class: int = 8, resolution: int = 28,
                   serve: bool = False, base_port: int = 8777,
                   seed: int = 0, device="cuda") -> Sandbox:
    """Grid nodes on ``device``, each pre-loaded with a toy 3-class image
    dataset, the same arrays as the JAX package's sandbox for a seed."""
    from primia_tpu_torch.serve.node import GridNode, NodeServer

    rng = np.random.default_rng(seed)
    nodes: Dict[str, GridNode] = {}
    for w in worker_names:
        node = GridNode(w, device=device)
        imgs, labels = [], []
        for ci in range(3):
            base = 40 + 60 * ci
            arr = rng.integers(0, 80, (n_per_class, resolution, resolution, 1))
            imgs.append((arr + base).astype(np.uint8))
            labels.append(np.full(n_per_class, ci, np.int32))
        data = np.concatenate(imgs)
        node.host_images("#traindata", data)
        node.store["#traintargets"] = np.concatenate(labels)
        x = data.astype(np.float32) / 255.0
        node.store["#datamean"] = x.mean(axis=(0, 1, 2))
        node.store["#datastd"] = x.std(axis=(0, 1, 2))
        nodes[w] = node
    nodes["crypto_provider"] = GridNode("crypto_provider", device=device)

    sb = Sandbox(nodes=nodes)
    if serve:
        from primia_tpu_torch.serve.client import NodeClient

        for i, (w, node) in enumerate(nodes.items()):
            srv = NodeServer(node, port=base_port + i).start()
            sb.servers.append(srv)
            sb.clients.append(NodeClient(w, "127.0.0.1", base_port + i))
    return sb
