"""Client side of the node RPC: ws with HTTP fallback, and grid search.

Port of ``primia_tpu/serve/client.py`` (reference ``DataCentricFLClient``,
``syft/grid/clients/data_centric_fl_client.py:19-359``, and
``PrivateGridNetwork``, ``syft/grid/private_grid.py:18-113``). The wire is
the JAX package's, so these clients talk to JAX nodes and port nodes
alike. ``GridNetwork.serve_model`` takes the port's ``nn.Module`` or a
JAX-layout ``(params, state)`` tree pair and sends the JAX trees.
"""

from __future__ import annotations

import urllib.request
from typing import Dict, List, Optional

import numpy as np
import torch

from primia_tpu_torch.config import read_worker_config
from primia_tpu_torch.serve.protocol import pack, unpack


class NodeClient:
    """One remote node; ws primary, HTTP POST fallback
    (``--http_protocol`` forces HTTP, as in the reference CLI).
    ``last_transport`` names the transport that carried the last reply."""

    def __init__(self, node_id: str, host: str, port: int,
                 http_only: bool = False, timeout: float = 600.0,
                 user: Optional[str] = None, token: Optional[str] = None):
        # generous default: a remote encrypted request blocks on the node's
        # first build of its predict function (the reference passes
        # timeout=60000s for the same reason, inference.py:121)
        self.id = node_id
        self.host = host
        self.port = int(port)
        self.http_only = http_only
        self.timeout = timeout
        # credential presented against allowed-users-gated objects
        self.user = user
        # JWT bearer token for authenticated nodes (serve/auth.py)
        self.token = token
        self._ws = None
        self.last_transport: Optional[str] = None

    def _ensure_ws(self):
        if self._ws is None:
            from websockets.sync.client import connect

            self._ws = connect(
                f"ws://{self.host}:{self.port}", open_timeout=self.timeout,
                max_size=None,
            )
        return self._ws

    def _http_send(self, msg: dict) -> dict:
        req = urllib.request.Request(
            f"http://{self.host}:{self.port + 1000}/", data=pack(msg), method="POST"
        )
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            out = unpack(resp.read())
        self.last_transport = "http"
        return out

    def send(self, msg: dict) -> dict:
        if self.user is not None and "user" not in msg:
            msg = {**msg, "user": self.user}
        if self.token is not None and "token" not in msg:
            msg = {**msg, "token": self.token}
        if self.http_only:
            return self._http_send(msg)
        try:
            ws = self._ensure_ws()
            ws.send(pack(msg))
            out = unpack(ws.recv(timeout=self.timeout))
            self.last_transport = "ws"
            return out
        except Exception:
            # silent HTTP fallback, mirroring data_centric_fl_client.py:183-212
            self._ws = None
            return self._http_send(msg)

    # convenience RPCs
    def status(self) -> dict:
        return self.send({"type": "status"})

    def get_obj(self, tag: str) -> np.ndarray:
        out = self.send({"type": "get_obj", "tag": tag})
        if "error" in out:
            raise KeyError(out["error"])
        return out["array"]

    def close(self):
        if self._ws is not None:
            self._ws.close()
            self._ws = None


class GridNetwork:
    """Tag search across a set of nodes (PrivateGridNetwork analogue)."""

    def __init__(self, clients: List[NodeClient]):
        self.clients = clients

    def search(self, *tags: str) -> Dict[str, List[str]]:
        out = {}
        for c in self.clients:
            found = c.send({"type": "search", "query": list(tags)})["results"]
            if found:
                out[c.id] = found
        return out

    def serve_model(self, node_id: str, *, name: str, params, model_state=None,
                    args_json: str, mean, std, allow_download: bool = False,
                    allow_remote_inference: bool = True) -> dict:
        """Host a model on a node (reference ``PrivateGridNetwork.serve_model``,
        ``private_grid.py:41-113``). ``params`` is the port's model (its
        JAX trees are sent; ``model_state`` is then unused) or a JAX-layout
        params tree beside its ``model_state``."""
        from primia_tpu_torch.nn.jax_params import to_jax_tree
        from primia_tpu_torch.serve.node import _flatten

        if isinstance(params, torch.nn.Module):
            params, model_state = to_jax_tree(params)
        return self._by_id(node_id).send({
            "type": "host_model", "name": name,
            "params": _flatten(params), "model_state": _flatten(model_state),
            "args": args_json, "mean": np.asarray(mean), "std": np.asarray(std),
            "allow_download": allow_download,
            "allow_remote_inference": allow_remote_inference,
        })

    def run_remote_inference(self, node_id: str, *, name: str, images=None,
                             encrypted: bool = False, protocol: str = "snn"):
        """Classify on the node hosting the model; images (or its own hosted
        ``#inference_data``) never leave in plaintext when ``encrypted``
        (reference ``run_remote_inference``)."""
        msg = {"type": "run_inference", "name": name, "encrypted": encrypted,
               "protocol": protocol}
        if images is not None:
            msg["images"] = images
        out = self._by_id(node_id).send(msg)
        if "error" in out:
            raise RuntimeError(out["error"])
        return out

    def serve_plan(self, node_id: str, plan) -> dict:
        """Host a traced Plan on a node (``serve/plan.py``)."""
        return self._by_id(node_id).send(
            {"type": "host_plan", "name": plan.name, "blob": plan.serialize()})

    def run_remote_plan(self, node_id: str, name: str, *args, input_tags=()):
        """Execute a hosted plan remotely; extra inputs can come from the
        node's own hosted tags, so that data never travels."""
        from primia_tpu_torch.serve.node import leaves

        flat = [np.asarray(a) for a in leaves(list(args))]
        out = self._by_id(node_id).send(
            {"type": "run_plan", "name": name, "inputs": flat,
             "input_tags": list(input_tags)})
        if "error" in out:
            raise RuntimeError(out["error"])
        outs = out["outputs"]
        return outs[0] if len(outs) == 1 else outs

    def fetch_plan(self, node_id: str, name: str):
        """Download a hosted plan for local execution (reference
        ``fetch_plan``)."""
        from primia_tpu_torch.serve.plan import Plan

        out = self._by_id(node_id).send({"type": "get_plan", "name": name})
        if "error" in out:
            raise RuntimeError(out["error"])
        return Plan.deserialize(out["blob"])

    def _by_id(self, node_id: str) -> "NodeClient":
        for c in self.clients:
            if c.id == node_id:
                return c
        raise KeyError(f"no node {node_id!r} in this grid")


def clients_from_csv(path, http_only: bool = False) -> Dict[str, NodeClient]:
    cfg = read_worker_config(path)
    return {
        wid: NodeClient(wid, w["host"], int(w["port"]), http_only=http_only)
        for wid, w in cfg.items()
    }


class RemoteInferenceSession:
    """The inference CLI's remote mode: locate the data owner's hosted
    ``#inference_data`` and fetch it (plain) for classification."""

    def __init__(self, csv_path: str, http_only: bool = False):
        self.clients = clients_from_csv(csv_path, http_only=http_only)
        if "data_owner" not in self.clients:
            raise ValueError("websockets_config must define a data_owner")

    def fetch_inference_data(self) -> np.ndarray:
        return self.clients["data_owner"].get_obj("#inference_data")

    def fetch_data_shares(self, party: Optional[int] = None, seed: int = 0,
                          frac_bits: int = 16):
        out = self.clients["data_owner"].send({
            "type": "get_data_shares", "tag": "#inference_data",
            "party": -1 if party is None else party, "seed": seed,
            "frac_bits": frac_bits,
        })
        if "error" in out:
            raise KeyError(out["error"])
        return out.get("shares", out.get("share"))

    def close(self):
        for c in self.clients.values():
            c.close()
