"""Disk-backed node warehouse: hosted models, plans, objects and FL
processes survive a restart.

Port of ``primia_tpu/serve/warehouse.py``, a copy (reference SQLAlchemy
warehouse, ``Node/app/main/core/*``): a stdlib ``sqlite3`` index for
metadata plus the checkpoint npz codec (``train/checkpoint.py:save_tree``)
for array payloads, one directory a node. Everything the node hosts at
run time is written through here and reloaded at boot.
"""

from __future__ import annotations

import io
import json
import sqlite3
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from primia_tpu_torch.train.checkpoint import load_tree, save_tree

_SCHEMA = """
CREATE TABLE IF NOT EXISTS models (
    name TEXT PRIMARY KEY,
    meta TEXT NOT NULL,         -- json: args/allow flags
    file TEXT NOT NULL          -- npz payload path (params/state/mean/std)
);
CREATE TABLE IF NOT EXISTS plans (
    name TEXT PRIMARY KEY,
    blob BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS objects (
    tag TEXT PRIMARY KEY,
    file TEXT NOT NULL,         -- npz payload path
    allowed_users TEXT          -- json list or NULL
);
CREATE TABLE IF NOT EXISTS fl_processes (
    name TEXT PRIMARY KEY,
    state TEXT NOT NULL,        -- json: config/version/cycle bookkeeping
    file TEXT NOT NULL          -- npz payload path (current model params)
);
"""


class Warehouse:
    def __init__(self, root: str | Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        (self.root / "blobs").mkdir(exist_ok=True)
        self._lock = threading.Lock()
        self._db = sqlite3.connect(
            self.root / "warehouse.sqlite", check_same_thread=False
        )
        with self._lock:
            self._db.executescript(_SCHEMA)
            self._db.commit()

    # ------------------------------------------------------------ blobs

    def _blob_path(self, kind: str, name: str) -> Path:
        # filesystem-safe deterministic filename
        import hashlib

        digest = hashlib.sha256(name.encode()).hexdigest()[:24]
        return self.root / "blobs" / f"{kind}_{digest}.npz"

    # ------------------------------------------------------------ models

    def put_model(self, name: str, payload: Dict[str, Any], meta: Dict[str, Any]):
        path = self._blob_path("model", name)
        save_tree(path, payload)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO models (name, meta, file) VALUES (?,?,?)",
                (name, json.dumps(meta), str(path)),
            )
            self._db.commit()

    def get_model(self, name: str) -> Optional[Tuple[Dict, Dict]]:
        with self._lock:
            row = self._db.execute(
                "SELECT meta, file FROM models WHERE name=?", (name,)
            ).fetchone()
        if row is None:
            return None
        return load_tree(row[1]), json.loads(row[0])

    def list_models(self) -> List[str]:
        with self._lock:
            return [r[0] for r in self._db.execute("SELECT name FROM models")]

    def delete_model(self, name: str):
        with self._lock:
            self._db.execute("DELETE FROM models WHERE name=?", (name,))
            self._db.commit()
        self._blob_path("model", name).unlink(missing_ok=True)

    # ------------------------------------------------------------ plans

    def put_plan(self, name: str, blob: bytes):
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO plans (name, blob) VALUES (?,?)",
                (name, sqlite3.Binary(bytes(blob))),
            )
            self._db.commit()

    def get_plan(self, name: str) -> Optional[bytes]:
        with self._lock:
            row = self._db.execute(
                "SELECT blob FROM plans WHERE name=?", (name,)
            ).fetchone()
        return bytes(row[0]) if row else None

    def list_plans(self) -> List[str]:
        with self._lock:
            return [r[0] for r in self._db.execute("SELECT name FROM plans")]

    def delete_plan(self, name: str):
        with self._lock:
            self._db.execute("DELETE FROM plans WHERE name=?", (name,))
            self._db.commit()

    # ----------------------------------------------------------- objects

    def put_object(self, tag: str, array: np.ndarray,
                   allowed_users: Optional[List[str]] = None):
        path = self._blob_path("obj", tag)
        save_tree(path, {"a": np.asarray(array)})
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO objects (tag, file, allowed_users) "
                "VALUES (?,?,?)",
                (tag, str(path),
                 json.dumps(allowed_users) if allowed_users else None),
            )
            self._db.commit()

    def delete_object(self, tag: str):
        with self._lock:
            self._db.execute("DELETE FROM objects WHERE tag=?", (tag,))
            self._db.commit()
        self._blob_path("obj", tag).unlink(missing_ok=True)

    def load_objects(self) -> Dict[str, Tuple[np.ndarray, Optional[List[str]]]]:
        with self._lock:
            rows = self._db.execute(
                "SELECT tag, file, allowed_users FROM objects"
            ).fetchall()
        out = {}
        for tag, file, users in rows:
            out[tag] = (load_tree(file)["a"],
                        json.loads(users) if users else None)
        return out

    # ------------------------------------------------------ fl processes

    def put_process(self, name: str, state: Dict[str, Any], params_payload: Dict):
        path = self._blob_path("proc", name)
        save_tree(path, params_payload)
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO fl_processes (name, state, file) "
                "VALUES (?,?,?)",
                (name, json.dumps(state), str(path)),
            )
            self._db.commit()

    def update_process_state(self, name: str, state: Dict[str, Any]):
        with self._lock:
            self._db.execute(
                "UPDATE fl_processes SET state=? WHERE name=?",
                (json.dumps(state), name),
            )
            self._db.commit()

    def get_process(self, name: str) -> Optional[Tuple[Dict, Dict]]:
        with self._lock:
            row = self._db.execute(
                "SELECT state, file FROM fl_processes WHERE name=?", (name,)
            ).fetchone()
        if row is None:
            return None
        return json.loads(row[0]), load_tree(row[1])

    def list_processes(self) -> List[str]:
        with self._lock:
            return [r[0] for r in self._db.execute("SELECT name FROM fl_processes")]

    def close(self):
        with self._lock:
            self._db.close()
