"""Run a function on N ranks, each a process of its own, and collect what
each returns.

:func:`spawn` starts ``python -m primia_tpu_torch.parallel.launch`` N
times on a free local port, in a clean environment (no torchrun
variables, one intra-op thread), waits for every rank under one deadline
and returns, for each rank, the function's result and the kernel launch
counters of that process (counters are per process: a path's launches
are read where they happen). A rank that fails, or a run past its
deadline, fails the whole run: the other ranks are killed, so a hung
rendezvous cannot hang the caller.

The function is named ``"package.module:function"`` (or
``"path/to/file.py:function"``) and called on every rank as
``function(payload)`` after :func:`multihost.initialize`; ``payload`` is
any object ``torch.save`` takes. This module also holds the rank
programs that the tests and ``chip_smoke.py`` run: a data-parallel train
or eval step, and one secure FedAvg round over the node axis.

By hand::

    python -m primia_tpu_torch.parallel.launch --target mod:fn --rank 0 \\
        --world 2 --port 29500 --dir <dir with payload.pt> [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from primia_tpu_torch.ops._build import read_launches, reset_launches

ROOT = Path(__file__).resolve().parents[2]
_TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
             "LOCAL_WORLD_SIZE", "GROUP_RANK", "TORCHELASTIC_RUN_ID")


@dataclass
class RankResult:
    rank: int
    result: Any
    launches: Dict[str, int]
    seconds: float
    log: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(extra: Optional[Dict[str, str]]) -> Dict[str, str]:
    env = {k: v for k, v in os.environ.items() if k not in _TORCHRUN}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT)] + [p for p in env.get(
        "PYTHONPATH", "").split(os.pathsep) if p])
    env.update(extra or {})
    return env


def spawn(target: str, world: int, payload: Any = None, *, device="cuda",
          timeout: float = 300.0, workdir=None, env: Optional[Dict[str, str]] = None
          ) -> List[RankResult]:
    """Run ``target(payload)`` on ``world`` ranks; returns their results in
    rank order. Raises ``RuntimeError`` (with the ranks' logs) when a rank
    exits with an error or the ranks outlast ``timeout`` seconds."""
    own = workdir is None
    tmp = tempfile.TemporaryDirectory(prefix="primia-ranks-") if own else None
    wd = Path(tmp.name if own else workdir)
    wd.mkdir(parents=True, exist_ok=True)
    try:
        torch.save(payload, wd / "payload.pt")
        port = free_port()
        logs = [open(wd / f"rank{r}.log", "w+") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "primia_tpu_torch.parallel.launch", "--target", target,
             "--rank", str(r), "--world", str(world), "--port", str(port),
             "--device", str(device), "--dir", str(wd)],
            cwd=str(ROOT), env=_clean_env(env), stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.poll() is None for p in procs):
            bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad:
                failed = f"rank {bad[0]} exited with {procs[bad[0]].returncode}"
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        if failed is None and any(p.returncode for p in procs):
            failed = "a rank failed: " + ", ".join(f"rank {r} exited {p.returncode}"
                                                  for r, p in enumerate(procs) if p.returncode)
        if failed:
            tails = "\n".join(f"--- rank {r} ---\n{t[-3000:]}" for r, t in enumerate(texts))
            raise RuntimeError(f"{target} on {world} ranks: {failed}\n{tails}")
        out = []
        for r in range(world):
            got = torch.load(wd / f"rank{r}.pt", weights_only=False)
            out.append(RankResult(r, got["result"], got["launches"], got["seconds"], texts[r]))
        return out
    finally:
        if tmp is not None:
            tmp.cleanup()


def _resolve(target: str):
    mod, fn = target.rsplit(":", 1)
    if mod.endswith(".py"):
        spec = importlib.util.spec_from_file_location(Path(mod).stem, mod)
        m = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(m)
    else:
        m = importlib.import_module(mod)
    return getattr(m, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dir", required=True)
    a = ap.parse_args(argv)
    import torch.distributed as dist

    from primia_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{a.port}", a.world, a.rank, device=a.device)
    fn = _resolve(a.target)
    payload = torch.load(Path(a.dir) / "payload.pt", weights_only=False)
    reset_launches()
    result = fn(payload)
    launches = read_launches()
    dist.barrier()
    dist.destroy_process_group()
    torch.save({"result": result, "launches": launches, "seconds": time.perf_counter() - t0},
               Path(a.dir) / f"rank{a.rank}.pt")
    return 0


# ------------------------------------------------------------ rank programs

def _device(payload) -> torch.device:
    from primia_tpu_torch.parallel import multihost

    return multihost.rank_device(payload.get("device", "cuda"))


def _model(payload, device):
    """``payload["model"]`` (a module) or the model ``args`` describe, with
    ``state_dict``, on ``device``."""
    from primia_tpu_torch.nn import create_model

    if "model" in payload:
        return payload["model"].to(device)
    model = create_model(payload["args"], num_classes=payload["num_classes"], device=device)
    model.load_state_dict(payload["state_dict"])
    return model


class GradRecorder:
    """Stands in for the optimizer: keeps the (reduced) gradients."""

    def __init__(self, model):
        from primia_tpu_torch.nn.jax_params import param_leaves

        self.names = [n for n, _ in param_leaves(model)]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]
        self.grads = None

    def update(self, grads, lr):
        self.grads = {n: g.detach().cpu().clone() for n, g in zip(self.names, grads)}


def train_steps(payload) -> Dict[str, Any]:
    """Rank program: ``payload["steps"]`` data-parallel train steps of the
    model ``payload["args"]`` describes, from ``state_dict``, on the whole
    batches ``batches`` (a list of (images, labels, mask)), with a
    generator on the rank's device seeded ``seed``. With ``record`` the
    optimizer is a recorder and the first step's reduced gradients come
    back. Returns the losses, the gradients, the final state dict (CPU)."""
    from primia_tpu_torch.parallel.data_parallel import (data_parallel_mesh, replicate,
                                                         shard_train_step)
    from primia_tpu_torch.train.optim import make_optimizer

    device = _device(payload)
    args = payload["args"]
    mesh = data_parallel_mesh()
    model = replicate(_model(payload, device), mesh)
    opt = GradRecorder(model) if payload.get("record") else make_optimizer(args, model)
    step = shard_train_step(model, opt, args, payload["mean"], payload["std"],
                            payload.get("class_weights"), mesh=mesh, device=device)
    gen = torch.Generator(device=device).manual_seed(payload.get("seed", 0))
    losses, grads = [], None
    for images, labels, mask in payload["batches"]:
        losses.append(float(step(gen, images, labels, mask, payload.get("lr", 1e-4))))
        if grads is None and payload.get("record"):
            grads = opt.grads
    return {"losses": losses, "grads": grads,
            "state_dict": {k: v.detach().cpu() for k, v in model.state_dict().items()}}


def eval_step(payload) -> Dict[str, Any]:
    """Rank program: one data-parallel eval step; (loss, logits)."""
    from primia_tpu_torch.parallel.data_parallel import data_parallel_mesh, shard_eval_step

    device = _device(payload)
    model = _model(payload, device)
    step = shard_eval_step(model, payload["args"], payload["mean"], payload["std"],
                           mesh=data_parallel_mesh(), device=device)
    loss, logits = step(*payload["batch"])
    return {"loss": float(loss), "logits": logits.cpu()}


def secure_fedavg_round(payload) -> Dict[str, Any]:
    """Rank program: one secure FedAvg round over a (node, data) mesh of
    ``n_nodes`` nodes; each rank holds its node rows of ``stacked``
    (numpy leaves, the whole stack) on its device."""
    from primia_tpu_torch.mpc.aggregation import map_with_path
    from primia_tpu_torch.parallel import multihost

    device = _device(payload)
    mesh = multihost.federated_mesh(payload["n_nodes"])
    per = len(payload["weights"]) // mesh.shape["node"]
    lo = mesh.index("node") * per

    local = map_with_path(lambda _, v: torch.from_numpy(np.array(v[lo:lo + per])).to(device),
                          payload["stacked"])
    out = multihost.secure_fedavg(payload["key"], local,
                                  payload["weights"], mesh)
    return {"topology": multihost.slice_topology(), "backend": multihost.backend(),
            "out": map_with_path(lambda _, v: v.cpu(), out)}


def mesh_info(payload) -> Dict[str, Any]:
    """Rank program: this rank's topology, backend and place on the
    federated mesh of ``payload["n_nodes"]`` nodes, and its rows of
    ``arange(8)`` on the data-parallel mesh of every rank."""
    from primia_tpu_torch.parallel import multihost
    from primia_tpu_torch.parallel.data_parallel import data_parallel_mesh, shard_batch

    mesh = multihost.federated_mesh(payload["n_nodes"])
    return {"topology": multihost.slice_topology(), "backend": multihost.backend(),
            "ranks": mesh.devices.tolist(), "shape": mesh.shape,
            "node": mesh.index("node"), "data": mesh.index("data"),
            "rows": shard_batch({"x": np.arange(8)}, data_parallel_mesh())["x"].tolist()}


if __name__ == "__main__":
    sys.exit(main())
