"""Grid node server: a hospital's data and compute endpoint.

Port of ``primia_tpu/serve/node.py`` (the reference's ``python -m Node``),
verb for verb, over the same wire (``serve/protocol.py``), so a JAX
client talks to a port node and a port client to a JAX node. The node
hosts its data and answers a small typed RPC surface, msgpack frames
over a WebSocket with an HTTP POST fallback:

- ``status``, ``search``, ``get_obj``, ``load_data``, ``delete_obj``:
  hosted arrays by tag, behind the allowed-users gate;
- ``get_data_shares``: the fixed-point, two-party additive shares of a
  hosted tensor, from ``native.encode_and_share`` keyed by the node's
  secret;
- ``train_round``: local training steps on the node's own shard; the raw
  data never leaves it, and the parameters come back;
- ``host_model`` / ``run_inference`` (plain, or encrypted under ``snn`` or
  ``fss``) with replica failover, ``host_plan`` / ``run_plan`` /
  ``get_plan``, and the model-centric ``fl_*`` verbs.

The node computes on ``device`` (``"cuda"``, the default, raises without
a card; or ``"cpu"``). Its hosted images go up to the device once, at
boot (``data/loader.py:to_device_resident``). A remote plain request runs
``train/steps.py:build_predict_step`` (CLAHE on K3 once a request), an
encrypted one ``mpc/inference.py:build_encrypted_predict``, and a
``train_round`` the step ``train/dp.py:select_train_step`` picks (K1 four
times and K3 once a step on the canonical recipe). Parameters cross the
wire as the JAX package's trees, flattened to ``jax.tree_util.keystr``
paths in ``jax.tree_util.tree_flatten_with_path`` order (dict keys
sorted), and are carried into the port's modules by ``nn/jax_params.py``.

Boot-time data hosting mirrors ``Node/app/__init__.py:235-388``: a
``data_owner`` hosts ``#inference_data``; a training worker hosts
``#traindata``, ``#traintargets``, ``#datamean`` and ``#datastd``.

``python -m primia_tpu_torch.serve.node --id alice --port 8777
--data_directory <dir> [--device cuda|cpu]`` serves ws on ``port`` and
HTTP on ``port + 1000``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from primia_tpu_torch import DEVICES, resolve_device
from primia_tpu_torch.mpc.aggregation import _keystr
from primia_tpu_torch.nn.jax_params import tree_paths
from primia_tpu_torch.serve.protocol import pack, unpack


class GridNode:
    def __init__(self, node_id: str, data_directory: Optional[str] = None,
                 config: Optional[str] = None, mean_std_file: Optional[str] = None,
                 inference_resolution: int = 224, channels: int = 1,
                 storage_dir: Optional[str] = None,
                 auth_secret: Optional[bytes] = None,
                 num_replicas: int = 1, device="cuda"):
        self.id = node_id
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self.store: Dict[str, np.ndarray] = {}
        # hosted image tags on the device (uploaded once, at boot)
        self._resident: Dict[str, object] = {}
        self.models: Dict[str, dict] = {}  # hosted models (serve_model)
        self.plans: Dict[str, bytes] = {}  # hosted plans (serve/plan.py)
        self._plan_cache: Dict[str, object] = {}
        # authenticated identity: with a secret set, every gated verb needs
        # a valid HS256 JWT and the acting user is the token's ``sub``
        # (reference JWT auth, model_centric/routes.py:37-90)
        self.auth_secret = auth_secret
        # hosted-model replica slots (--num_replicas, reference
        # Node/__main__.py:44-49): inference fails over to the next healthy one
        self.num_replicas = max(1, int(num_replicas))
        self.replicas: Dict[str, list] = {}
        self.fl_processes: Dict[str, object] = {}  # serve/model_centric.py
        self.warehouse = None
        if storage_dir:
            from primia_tpu_torch.serve.warehouse import Warehouse

            self.warehouse = Warehouse(storage_dir)
        # per-tag allowed-users gate (the PrivateTensor role): an object
        # hosted with allowed users is invisible to and unfetchable by others
        self.acl: Dict[str, frozenset] = {}
        # node-private share-stream secret: the client's seed only makes the
        # two parties' requests consistent; the mask is keyed by this secret
        self._share_secret = os.urandom(16)
        self.config_path = config
        self.inference_resolution = inference_resolution
        self.channels = channels
        if config:
            from primia_tpu_torch.config import Arguments

            self.args = Arguments.from_ini(config, mode="train")
            self.inference_resolution = self.args.inference_resolution
            self.channels = 1 if not self.args.pretrained else 3
        else:
            self.args = None
        if self.warehouse is not None:
            self._restore_from_warehouse()
        if data_directory:
            self._host_data(Path(data_directory), mean_std_file)

    def _host_data(self, data_dir: Path, mean_std_file: Optional[str]):
        from primia_tpu_torch.data import ImageFolderDataset, PathDataset, calc_mean_std

        has_classes = any(p.is_dir() for p in data_dir.iterdir())
        if self.id == "data_owner" or not has_classes:
            ds = PathDataset(data_dir, channels=self.channels)
            imgs, _ = ds.materialize(self.inference_resolution)
            self.host_images("#inference_data", imgs)
            if mean_std_file:
                ms = np.load(mean_std_file)
                self.store["#datamean"], self.store["#datastd"] = ms["mean"], ms["std"]
        else:
            ds = ImageFolderDataset(data_dir, channels=self.channels)
            imgs, labels = ds.materialize(self.inference_resolution)
            mean, std = calc_mean_std(imgs)
            self.host_images("#traindata", imgs)
            self.store["#traintargets"] = labels
            self.store["#datamean"] = np.asarray(mean)
            self.store["#datastd"] = np.asarray(std)

    def host_images(self, tag: str, imgs: np.ndarray) -> None:
        """Host a uint8 (N, R, R, C) image array under ``tag`` (``#traindata``
        or ``#inference_data``), with its copy on the node's device."""
        from primia_tpu_torch.data import to_device_resident

        self.store[tag] = imgs
        self._resident[tag] = to_device_resident(imgs, self.device)

    def _images(self, tag: str):
        """A hosted image array, from the device when it went up there."""
        return self._resident.get(tag, self.store[tag])

    def _restore_from_warehouse(self):
        """Reload persisted objects, models, plans and FL processes at boot
        (reference SQLAlchemy warehouse, ``Node/app/main/core/``)."""
        from primia_tpu_torch.serve.model_centric import FLProcess

        for tag, (arr, users) in self.warehouse.load_objects().items():
            self.store[tag] = arr
            if users:
                self.acl[tag] = frozenset(users)
        for name in self.warehouse.list_models():
            payload, meta = self.warehouse.get_model(name)
            self.models[name] = {**payload, **meta,
                                 "mean": np.asarray(payload["mean"]),
                                 "std": np.asarray(payload["std"])}
            self.replicas[name] = [
                {"healthy": True} for _ in range(self.num_replicas)]
        for name in self.warehouse.list_plans():
            self.plans[name] = self.warehouse.get_plan(name)
        for name in self.warehouse.list_processes():
            state, payload = self.warehouse.get_process(name)
            self.fl_processes[name] = FLProcess.from_state(
                state, payload["params"], payload.get("plan_blob"))

    # ------------------------------------------------------------ handlers

    def _authenticate(self, msg: dict):
        """JWT claims when auth is enabled (raising on a bad or missing
        token), else None."""
        from primia_tpu_torch.serve.auth import AuthError, verify_token

        if self.auth_secret is None:
            return None
        token = msg.get("token")
        if not token:
            raise AuthError("authentication required")
        return verify_token(self.auth_secret, token)

    def _permitted(self, tag: str, msg: dict) -> bool:
        """The allowed-users gate; with auth enabled the acting user is the
        verified token subject, not a client-asserted field."""
        allowed = self.acl.get(tag)
        if allowed is None:
            return True
        if self.auth_secret is not None:
            from primia_tpu_torch.serve.auth import AuthError

            try:
                claims = self._authenticate(msg)
            except AuthError:
                return False
            return claims["sub"] in allowed
        return msg.get("user") in allowed

    def _require(self, msg: dict, capability: str):
        """Gate a verb on a role capability when auth is enabled."""
        from primia_tpu_torch.serve.auth import require

        claims = self._authenticate(msg)
        if claims is not None:
            require(claims, capability)
        return claims

    def handle(self, msg: dict) -> dict:
        from primia_tpu_torch.serve.auth import AuthError

        try:
            return self._dispatch(msg)
        except AuthError as e:
            return {"error": f"auth: {e}"}

    def _dispatch(self, msg: dict) -> dict:
        op = msg.get("type")
        if op is not None and str(op).startswith("fl_"):
            return self._handle_model_centric(op, msg)
        if op == "status":
            return {"id": self.id, "tags": sorted(
                t for t in self.store if self._permitted(t, msg))}
        if op == "search":
            q = msg.get("query", [])
            return {"results": [t for t in self.store
                                if (t in q or not q) and self._permitted(t, msg)]}
        if op == "get_obj":
            tag = msg["tag"]
            if tag not in self.store or not self._permitted(tag, msg):
                # one answer whether absent or private
                return {"error": f"no object tagged {tag}"}
            return {"tag": tag, "array": self.store[tag]}
        if op == "load_data":
            self._require(msg, "host")
            self.store[msg["tag"]] = msg["array"]
            self._resident.pop(msg["tag"], None)
            if msg.get("allowed_users"):
                self.acl[msg["tag"]] = frozenset(msg["allowed_users"])
            else:
                self.acl.pop(msg["tag"], None)
            if self.warehouse is not None:
                self.warehouse.put_object(
                    msg["tag"], msg["array"], msg.get("allowed_users"))
            return {"ok": True}
        if op == "delete_obj":
            tag = msg["tag"]
            if tag not in self.store or not self._permitted(tag, msg):
                return {"error": f"no object tagged {tag}"}
            self.store.pop(tag, None)
            self._resident.pop(tag, None)
            self.acl.pop(tag, None)
            if self.warehouse is not None:
                self.warehouse.delete_object(tag)
            return {"ok": True}
        if op == "get_data_shares":
            tag = msg.get("tag", "#inference_data")
            if tag in self.store and not self._permitted(tag, msg):
                return {"error": f"no object tagged {tag}"}
            return self._get_data_shares(msg)
        if op == "train_round":
            return self._train_round(msg)
        if op == "host_model":
            self._require(msg, "host")
            return self._host_model(msg)
        if op == "list_models":
            return {"models": sorted(self.models)}
        if op == "delete_model":
            self._require(msg, "host")
            self.models.pop(msg["name"], None)
            self.replicas.pop(msg["name"], None)
            if self.warehouse is not None:
                self.warehouse.delete_model(msg["name"])
            return {"ok": True}
        if op == "run_inference":
            return self._run_inference(msg)
        if op == "replica_status":
            name = msg["name"]
            if name not in self.replicas:
                return {"error": f"no model named {name!r}"}
            return {"name": name, "replicas": self.replicas[name]}
        if op == "set_replica_health":
            # admin / fault-injection hook: health is an explicit flag
            self._require(msg, "admin")
            name, idx = msg["name"], int(msg["replica"])
            if name not in self.replicas or not (
                    0 <= idx < len(self.replicas[name])):
                return {"error": "no such replica"}
            self.replicas[name][idx]["healthy"] = bool(msg["healthy"])
            return {"ok": True}
        if op == "host_plan":
            self._require(msg, "host")
            self.plans[msg["name"]] = msg["blob"]
            self._plan_cache.pop(msg["name"], None)
            if self.warehouse is not None:
                self.warehouse.put_plan(msg["name"], msg["blob"])
            return {"ok": True, "name": msg["name"]}
        if op == "list_plans":
            return {"plans": sorted(self.plans)}
        if op == "get_plan":
            if msg["name"] not in self.plans:
                return {"error": f"no plan named {msg['name']!r}"}
            return {"name": msg["name"], "blob": self.plans[msg["name"]]}
        if op == "run_plan":
            return self._run_plan(msg)
        return {"error": f"unknown message type {op!r}"}

    # ------------------------------------------- model-centric FL cycle
    # Reference: Node/app/main/routes/model_centric/routes.py:37-471.

    def _persist_process(self, proc):
        if self.warehouse is not None:
            self.warehouse.put_process(
                proc.name, proc.to_state(),
                {"params": proc.params, "plan_blob": proc.plan_blob})

    def _handle_model_centric(self, op: str, msg: dict) -> dict:
        from primia_tpu_torch.serve.model_centric import FLProcess

        if op == "fl_host_training":
            self._require(msg, "host")
            proc = FLProcess(
                msg["name"], msg["params"],
                plan_blob=msg.get("plan_blob"),
                client_config=msg.get("client_config"),
                server_config=msg.get("server_config"),
            )
            self.fl_processes[msg["name"]] = proc
            self._persist_process(proc)
            return {"ok": True, "name": proc.name, "version": proc.version}
        name = msg.get("name")
        proc = self.fl_processes.get(name)
        if proc is None:
            return {"error": f"no FL process named {name!r}"}
        if op == "fl_cycle_request":
            claims = self._require(msg, "fl_participate")
            worker = claims["sub"] if claims else msg.get("worker_id", "anon")
            out = proc.request_cycle(worker, msg.get("model_version"))
            self._persist_process(proc)
            return out
        if op == "fl_get_model":
            return proc.get_model(msg.get("request_key", ""))
        if op == "fl_get_plan":
            return proc.get_plan(msg.get("request_key", ""))
        if op == "fl_report":
            out = proc.report(msg.get("request_key", ""),
                              {k: np.asarray(v)
                               for k, v in msg.get("diff", {}).items()})
            self._persist_process(proc)
            return out
        if op == "fl_status":
            return proc.status()
        return {"error": f"unknown message type {op!r}"}

    def _run_plan(self, msg: dict) -> dict:
        """Execute a hosted plan on supplied (or hosted) inputs."""
        from primia_tpu_torch.serve.plan import Plan

        name = msg["name"]
        if name not in self.plans:
            return {"error": f"no plan named {name!r}"}
        plan = self._plan_cache.get(name)
        if plan is None:
            try:
                plan = Plan.deserialize(self.plans[name])
            except ValueError as e:
                return {"error": str(e)}
            self._plan_cache[name] = plan
        inputs = [np.asarray(a) for a in msg.get("inputs", [])]
        for tag in msg.get("input_tags", []):  # hosted-data inputs by tag
            if tag not in self.store or not self._permitted(tag, msg):
                return {"error": f"no object tagged {tag}"}
            inputs.append(self.store[tag])
        try:
            outs = plan.run_flat(inputs)
        except ValueError as e:
            return {"error": str(e)}
        return {"outputs": outs}

    # ------------------------------------------------- model hosting
    # Reference: PrivateGridNetwork.serve_model / run_remote_inference,
    # syft/grid/private_grid.py:18-113.

    def _host_model(self, msg: dict) -> dict:
        name = msg["name"]
        self.models[name] = {
            "params": _unflatten(msg["params"]),
            "model_state": _unflatten(msg["model_state"]),
            "args": msg["args"],
            "mean": np.asarray(msg["mean"]),
            "std": np.asarray(msg["std"]),
            "allow_download": bool(msg.get("allow_download", False)),
            "allow_remote_inference": bool(msg.get("allow_remote_inference", True)),
        }
        self.replicas[name] = [
            {"healthy": True} for _ in range(self.num_replicas)]
        if self.warehouse is not None:
            m = self.models[name]
            self.warehouse.put_model(
                name,
                {"params": m["params"], "model_state": m["model_state"],
                 "mean": m["mean"], "std": m["std"]},
                {"args": m["args"], "allow_download": m["allow_download"],
                 "allow_remote_inference": m["allow_remote_inference"]},
            )
        return {"ok": True, "name": name, "replicas": self.num_replicas}

    def _module(self, args, num_classes: int, params, state) -> torch.nn.Module:
        """The port's model for ``args`` on the node's device, holding the
        JAX-layout trees ``params`` and ``state``."""
        from primia_tpu_torch.nn import create_model
        from primia_tpu_torch.nn.jax_params import from_jax_tree

        model = create_model(args, num_classes=num_classes, device=self.device)
        model.load_state_dict(from_jax_tree(params, state))
        return model

    def _run_inference(self, msg: dict) -> dict:
        from primia_tpu_torch.config import Arguments
        from primia_tpu_torch.train.steps import build_predict_step

        name = msg["name"]
        if name not in self.models:
            return {"error": f"no model named {name!r}"}
        m = self.models[name]
        if not m["allow_remote_inference"]:
            return {"error": f"model {name!r} does not allow remote inference"}
        # replica failover: serve from the first healthy replica slot
        slots = self.replicas.get(name, [{"healthy": True}])
        serving = next((i for i, r in enumerate(slots) if r["healthy"]), None)
        if serving is None:
            return {"error": f"model {name!r}: all replicas unhealthy"}
        if "images" in msg:
            images = np.asarray(msg["images"])
        elif "#inference_data" in self.store:
            images = self._images("#inference_data")
        else:
            return {"error": "no images supplied and no hosted #inference_data"}
        args = Arguments.from_dict(json.loads(m["args"]))
        # one predict function per (mode, protocol, seed), built at first use
        protocol = msg.get("protocol", "snn")
        seed = int(msg.get("seed", 0))
        cache_key = (bool(msg.get("encrypted")), protocol, seed)
        predict = m.setdefault("_predict_cache", {}).get(cache_key)
        if predict is None:
            model = self._module(args, args.num_classes, m["params"], m["model_state"])
            if msg.get("encrypted"):
                from primia_tpu_torch.mpc.inference import build_encrypted_predict

                predict = build_encrypted_predict(model, args, m["mean"], m["std"],
                                                  self.device, protocol=protocol, seed=seed)
            else:
                predict = build_predict_step(model, args, m["mean"], m["std"], self.device)
            m["_predict_cache"][cache_key] = predict
        logits = predict(images).float().cpu().numpy()
        return {"logits": logits, "predictions": logits.argmax(1).astype(np.int32),
                "replica": serving}

    def _get_data_shares(self, msg: dict) -> dict:
        """Fixed-point encode + 2-party split of a hosted tensor; only the
        requested party's share leaves. The split runs through the native
        SHA-256-CTR share generator (``native.encode_and_share``)."""
        from primia_tpu_torch import native
        from primia_tpu_torch.mpc import fixed

        tag = msg.get("tag", "#inference_data")
        party = int(msg.get("party", -1))
        if tag not in self.store:
            return {"error": f"no object tagged {tag}"}
        data = self.store[tag]
        if data.dtype == np.uint8:  # normalize with hosted stats if present
            x = data.astype(np.float32) / 255.0
            if "#datamean" in self.store:
                m = self.store["#datamean"].reshape(1, 1, 1, -1)
                s = self.store["#datastd"].reshape(1, 1, 1, -1)
                x = (x - m) / s
        else:
            x = data
        frac = int(msg.get("frac_bits", fixed.DEFAULT_FRAC_BITS))
        # mask = PRG(node secret || tag || client seed): both parties' fetches
        # line up, but no requester can recompute the other party's mask
        seed_bytes = hashlib.sha256(
            self._share_secret + tag.encode() + str(int(msg.get("seed", 0))).encode()
        ).digest()
        s0, s1 = native.encode_and_share(x, frac, seed_bytes)
        if party in (0, 1):
            return {"tag": tag, "share": (s0 if party == 0 else s1),
                    "party": party, "frac_bits": frac}
        return {"tag": tag, "shares": np.stack([s0, s1]), "frac_bits": frac}

    def _train_round(self, msg: dict) -> dict:
        """``n_steps`` local train steps on the node's shard (federated ws
        mode): the step ``select_train_step`` picks for the round's args
        (DP-SGD clips and noises here, where the data lives), batches from
        ``BatchLoader(shuffle=True, seed=seed, pad_final=True)`` pass after
        pass, and the step's generator seeded from ``seed``. Returns the
        JAX-layout params and state, the shard's batch count and the mean
        loss."""
        from primia_tpu_torch.config import Arguments
        from primia_tpu_torch.data import BatchLoader
        from primia_tpu_torch.nn.jax_params import to_jax_tree
        from primia_tpu_torch.train.dp import select_train_step
        from primia_tpu_torch.train.optim import make_optimizer

        if "#traindata" not in self.store:
            return {"error": "node hosts no training data"}
        args = Arguments.from_dict(json.loads(msg["args"]))
        n_steps = int(msg["n_steps"])
        lr = float(msg["lr"])
        seed = int(msg.get("seed", 0))
        model = self._module(args, int(msg.get("num_classes", 3)),
                             _unflatten(msg["params"]), _unflatten(msg["model_state"]))
        optimizer = make_optimizer(args, model)
        step = select_train_step(model, optimizer, args, self.store["#datamean"],
                                 self.store["#datastd"], None, self.device)
        loader = BatchLoader(self._images("#traindata"), self.store["#traintargets"],
                             args.batch_size, shuffle=True, seed=seed, pad_final=True)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        it = iter(loader)
        losses = []
        for _ in range(n_steps):
            try:
                b = next(it)
            except StopIteration:
                it = iter(loader)
                b = next(it)
            losses.append(step(gen, b.images, b.labels, b.mask, lr))
        params, state = to_jax_tree(model)
        return {
            "params": _flatten(params),
            "model_state": _flatten(state),
            "n_batches": len(loader),
            "loss": float(np.mean(torch.stack(losses).cpu().numpy().astype(np.float64))),
        }


def leaves(tree) -> list:
    """A tree's leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in tree_paths(tree)]


def _flatten(tree) -> dict:
    """Tree -> ``{keystr path: ndarray}`` for the wire, in the order and
    with the keys of the JAX package's ``_flatten``."""
    return {_keystr(path): np.asarray(leaf) for path, leaf in tree_paths(tree)}


def _unflatten(flat: dict):
    """Inverse of _flatten for dict/list trees keyed like "['a'][0]['b']"."""
    root: dict = {}
    for path_str, leaf in flat.items():
        keys = []
        for part in path_str.strip("[]").split("]["):
            part = part.strip()
            if part.startswith("'") or part.startswith('"'):
                keys.append(part.strip("'\""))
            else:
                keys.append(int(part))
        node = root
        for a, b in zip(keys, keys[1:]):
            nxt = node.get(a) if isinstance(node, dict) else (
                node[a] if a < len(node) else None)
            if nxt is None:
                nxt = [] if isinstance(b, int) else {}
                if isinstance(node, dict):
                    node[a] = nxt
                else:
                    while len(node) <= a:
                        node.append(None)
                    node[a] = nxt
            node = nxt
        last = keys[-1]
        if isinstance(node, list):
            while len(node) <= last:
                node.append(None)
        node[last] = leaf
    return root


# ======================================================================
# transports
# ======================================================================

class NodeServer:
    """WebSocket (primary) + HTTP POST (fallback, on ``port + 1000``)
    front-ends over one GridNode, mirroring the reference's dual
    transports. The WebSocket server keeps the JAX node's frame limit,
    the ``websockets`` default of 1 MiB: a larger frame (a ResNet-18
    ``train_round``) is refused, and the client falls back to HTTP."""

    def __init__(self, node: GridNode, host: str = "127.0.0.1", port: int = 8777):
        self.node = node
        self.host = host
        self.port = port
        self._ws_server = None
        self._http_server = None
        self._threads = []

    def _reply(self, frame: bytes) -> bytes:
        try:
            reply = self.node.handle(unpack(frame))
        except Exception as e:  # serialized back like websocket_server.py:126
            reply = {"error": f"{type(e).__name__}: {e}"}
        return pack(reply)

    def _ws_handler(self, ws):
        for frame in ws:
            ws.send(self._reply(frame))

    def _serve(self, server) -> None:
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        self._threads.append(t)

    def start(self):
        from websockets.sync.server import serve

        self._ws_server = serve(self._ws_handler, self.host, self.port)
        self._serve(self._ws_server)

        node, reply = self.node, self._reply

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", 0))
                body = reply(self.rfile.read(length))
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802  (status/identity endpoint)
                body = json.dumps(node.handle({"type": "status"})).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self._http_server = ThreadingHTTPServer((self.host, self.port + 1000), Handler)
        self._serve(self._http_server)
        return self

    def stop(self):
        if self._ws_server:
            self._ws_server.shutdown()
        if self._http_server:
            self._http_server.shutdown()
            self._http_server.server_close()
        for t in self._threads:
            t.join(timeout=10)


def main(argv=None):
    parser = argparse.ArgumentParser(description="primia-tpu-torch grid node")
    parser.add_argument("--id", type=str, required=True)
    parser.add_argument("--port", type=int, required=True)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--data_directory", type=str, default=None)
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--mean_std_file", type=str, default=None)
    parser.add_argument("--storage_dir", type=str, default=None,
                        help="disk-backed warehouse: hosted models/plans/"
                             "objects survive restart")
    parser.add_argument("--num_replicas", type=int, default=1,
                        help="hosted-model replica slots (reference "
                             "Node/__main__.py:44-49)")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="Where the node computes (default cuda; without a card "
                             "it raises).")
    a = parser.parse_args(argv)
    # auth secret via env, like the reference's SECRET_KEY
    # (Node/__main__.py:22-49); unset -> unauthenticated node
    secret = os.environ.get("SECRET_KEY")
    node = GridNode(a.id, a.data_directory, a.config, a.mean_std_file,
                    storage_dir=a.storage_dir,
                    auth_secret=secret.encode() if secret else None,
                    num_replicas=a.num_replicas, device=a.device)
    server = NodeServer(node, a.host, a.port).start()
    print(f"node {a.id} serving ws://{a.host}:{a.port} "
          f"(http fallback :{a.port + 1000}) on {node.device}", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
