"""Serve layer (port of ``primia_tpu/serve``): the grid node server (data
hosting, remote inference and local-training RPCs), the client with its
ws/HTTP transports, and the fleet launcher."""

from primia_tpu_torch.serve.client import (  # noqa: F401
    GridNetwork,
    NodeClient,
    RemoteInferenceSession,
    clients_from_csv,
)
from primia_tpu_torch.serve.node import GridNode, NodeServer  # noqa: F401
