"""Model-centric federated learning cycles (the PyGrid FL protocol).

Port of ``primia_tpu/serve/model_centric.py``, a copy: host numpy
bookkeeping (reference ``Node/app/main/routes/model_centric/
routes.py:37-471``: ``/host-training``, ``/cycle-request``,
``/get-model``, ``/get-plan``, ``/report``). An FL process is (name,
model params, optional training plan, client and server config); workers
request a cycle, get an unguessable ``request_key``, download the model
and the plan (a port plan, ``serve/plan.py``), train locally and report a
parameter diff (old - new); when ``min_diffs`` reports arrive the averaged
diff is subtracted, the version bumps and the next cycle opens, until
``num_cycles`` have completed. State is written through the node's
warehouse when one is attached.
"""

from __future__ import annotations

import secrets
import time
from typing import Any, Dict, Optional

import numpy as np

DEFAULT_SERVER_CONFIG = {
    "max_workers": 3,       # accepted cycle participants
    "min_diffs": 2,         # reports needed to close a cycle
    "num_cycles": 5,        # cycles until the process completes
    "cycle_length": 3600.0, # seconds before an open cycle expires
}


class FLProcess:
    """One hosted model-centric training process."""

    def __init__(self, name: str, params: Dict[str, np.ndarray],
                 plan_blob: Optional[bytes] = None,
                 client_config: Optional[dict] = None,
                 server_config: Optional[dict] = None,
                 clock=time.time):
        self.name = name
        self.params = {k: np.asarray(v) for k, v in params.items()}
        self.plan_blob = plan_blob
        self.client_config = dict(client_config or {})
        self.server_config = {**DEFAULT_SERVER_CONFIG, **(server_config or {})}
        self.version = 1
        self.cycle = 1
        self.completed = False
        self._clock = clock
        self._cycle_start = clock()
        # request_key -> worker_id for the open cycle
        self._accepted: Dict[str, str] = {}
        # worker_id set that already reported this cycle (one diff each)
        self._reported: Dict[str, bool] = {}
        self._diff_sum: Optional[Dict[str, np.ndarray]] = None
        self._n_diffs = 0

    # ----------------------------------------------------------- cycle

    def _cycle_expired(self) -> bool:
        return (self._clock() - self._cycle_start) > float(
            self.server_config["cycle_length"])

    def _open_next_cycle(self):
        self.cycle += 1
        self._cycle_start = self._clock()
        self._accepted.clear()
        self._reported.clear()
        self._diff_sum = None
        self._n_diffs = 0

    def request_cycle(self, worker_id: str, model_version: Optional[int] = None) -> dict:
        """``/cycle-request``: accept or reject a worker for the open
        cycle (reference ``routes.py:37-120``)."""
        if self.completed:
            return {"status": "rejected", "reason": "process completed",
                    "model_version": self.version}
        if model_version is not None and int(model_version) != self.version:
            return {"status": "rejected", "reason": "stale model version",
                    "model_version": self.version}
        if self._cycle_expired():
            # expired cycle: close it with whatever arrived (or reopen)
            self._maybe_close_cycle(force=True)
            if self.completed:
                return {"status": "rejected", "reason": "process completed",
                        "model_version": self.version}
        already = [k for k, w in self._accepted.items() if w == worker_id]
        if already:
            key = already[0]  # idempotent re-request
        elif len(self._accepted) >= int(self.server_config["max_workers"]):
            return {"status": "rejected", "reason": "cycle full",
                    "timeout": float(self.server_config["cycle_length"])}
        else:
            key = secrets.token_hex(16)
            self._accepted[key] = worker_id
        return {
            "status": "accepted",
            "request_key": key,
            "cycle": self.cycle,
            "model_version": self.version,
            "client_config": self.client_config,
            "has_plan": self.plan_blob is not None,
        }

    def _check_key(self, request_key: str) -> Optional[str]:
        return self._accepted.get(request_key)

    def get_model(self, request_key: str) -> dict:
        if self._check_key(request_key) is None:
            return {"error": "invalid request_key"}
        return {"name": self.name, "version": self.version,
                "params": self.params}

    def get_plan(self, request_key: str) -> dict:
        if self._check_key(request_key) is None:
            return {"error": "invalid request_key"}
        if self.plan_blob is None:
            return {"error": f"process {self.name!r} hosts no plan"}
        return {"name": self.name, "blob": self.plan_blob}

    def report(self, request_key: str, diff: Dict[str, np.ndarray]) -> dict:
        """``/report``: accumulate a worker's diff; close the cycle when
        ``min_diffs`` reached (reference ``routes.py:380-471``)."""
        worker = self._check_key(request_key)
        if worker is None:
            return {"error": "invalid request_key"}
        if self._reported.get(worker):
            return {"error": "worker already reported this cycle"}
        if set(diff) != set(self.params):
            return {"error": "diff keys do not match model parameters"}
        self._reported[worker] = True
        if self._diff_sum is None:
            self._diff_sum = {k: np.zeros_like(np.asarray(v), dtype=np.float64)
                              for k, v in self.params.items()}
        for k, v in diff.items():
            v = np.asarray(v)
            if v.shape != self.params[k].shape:
                return {"error": f"diff shape mismatch for {k}"}
            self._diff_sum[k] += v.astype(np.float64)
        self._n_diffs += 1
        closed = self._maybe_close_cycle()
        return {"status": "success", "cycle_closed": closed,
                "model_version": self.version,
                "process_completed": self.completed}

    def _maybe_close_cycle(self, force: bool = False) -> bool:
        need = int(self.server_config["min_diffs"])
        if self._n_diffs < need and not (force and self._n_diffs > 0):
            if force:  # expired with zero diffs: restart the cycle clock
                self._cycle_start = self._clock()
                self._accepted.clear()
                self._reported.clear()
            return False
        # new_model = model - avg(diffs)  (the PyGrid convention: workers
        # report old - new, so subtracting the mean diff applies FedAvg)
        inv = 1.0 / self._n_diffs
        for k in self.params:
            self.params[k] = (
                self.params[k].astype(np.float64) - self._diff_sum[k] * inv
            ).astype(self.params[k].dtype)
        self.version += 1
        if self.cycle >= int(self.server_config["num_cycles"]):
            self.completed = True
            self._accepted.clear()
            self._reported.clear()
            return True
        self._open_next_cycle()
        return True

    # ------------------------------------------------------ persistence

    def to_state(self) -> dict:
        """JSON-serializable bookkeeping (params persist separately)."""
        return {
            "name": self.name,
            "client_config": self.client_config,
            "server_config": self.server_config,
            "version": self.version,
            "cycle": self.cycle,
            "completed": self.completed,
            "cycle_start": self._cycle_start,
            "accepted": self._accepted,
            "reported": self._reported,
            "n_diffs": self._n_diffs,
        }

    @classmethod
    def from_state(cls, state: dict, params: Dict[str, np.ndarray],
                   plan_blob: Optional[bytes], clock=time.time) -> "FLProcess":
        p = cls(state["name"], params, plan_blob,
                state.get("client_config"), state.get("server_config"),
                clock=clock)
        p.version = int(state["version"])
        p.cycle = int(state["cycle"])
        p.completed = bool(state["completed"])
        p._cycle_start = float(state["cycle_start"])
        p._accepted = dict(state.get("accepted", {}))
        p._reported = dict(state.get("reported", {}))
        # in-flight diff sums are NOT persisted (a restart drops partial
        # reports; workers re-report against the same cycle)
        p._n_diffs = 0
        p._reported = {}
        return p

    def status(self) -> dict:
        return {"name": self.name, "version": self.version,
                "cycle": self.cycle, "completed": self.completed,
                "accepted_workers": sorted(set(self._accepted.values())),
                "diffs_received": self._n_diffs,
                "server_config": self.server_config}
