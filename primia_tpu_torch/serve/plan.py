"""Plans: trace-once, execute-anywhere computation graphs.

Port of ``primia_tpu/serve/plan.py`` (reference ``syft/execution/plan.py``):
a Plan is a computation that can be shipped to a node and run there
without shipping Python code. The JAX package's Plan is a ``jax.export``
artifact (StableHLO); the port's is a ``torch.export`` ExportedProgram,
written with ``torch.export.save`` into the same envelope,
``pack({name, n_inputs, artifact})``. Neither package runs the other's
artifact: a port node handed a JAX plan answers ``{"error": ...}`` naming
it.

Wire contract, as in the JAX package: a plan's inputs and outputs are
flat lists of arrays (the argument tree is flattened at trace time, in
``jax.tree.leaves`` order). A plan runs on the device it was traced on.
``GridNode`` verbs: ``host_plan`` / ``list_plans`` / ``get_plan`` /
``run_plan``.
"""

from __future__ import annotations

import io
from typing import Callable, List, Sequence

import numpy as np
import torch

from primia_tpu_torch.serve.node import leaves
from primia_tpu_torch.serve.protocol import pack, unpack


_ZIP_MAGIC = b"PK\x03\x04"


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


class _Flat(torch.nn.Module):
    """``fn`` over the flat inputs, returning its flat outputs."""

    def __init__(self, fn: Callable, structure):
        super().__init__()
        self.fn = fn
        self.structure = structure

    def forward(self, *flat):
        it = iter(flat)
        args = _refill(self.structure, it)
        return tuple(leaves(self.fn(*args)))


def _refill(tree, it):
    """``tree`` with its leaves replaced, in order, from ``it``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out[k] = _refill(tree[k], it)
        return {k: out[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_refill(v, it) for v in tree)
    return next(it)


class Plan:
    """A traced, serialized computation. Call with the example-time
    argument structure; returns what the function returned."""

    def __init__(self, program, name: str, n_inputs: int):
        self._program = program
        self._module = program.module()
        self.name = name
        self.n_inputs = n_inputs
        user = set(program.graph_signature.user_inputs)
        self._devices = [n.meta["val"].device for n in program.graph.nodes
                         if n.op == "placeholder" and n.name in user]

    @staticmethod
    def trace(fn: Callable, *example_args, name: str = "plan") -> "Plan":
        """Trace ``fn`` on example args (any tree of arrays or tensors) into
        a Plan (reference ``func2plan`` / ``Plan.build``)."""
        flat = [_tensor(a) for a in leaves(list(example_args))]
        program = torch.export.export(_Flat(fn, list(example_args)), tuple(flat))
        return Plan(program, name, len(flat))

    def serialize(self) -> bytes:
        buf = io.BytesIO()
        torch.export.save(self._program, buf)
        return pack({"name": self.name, "n_inputs": self.n_inputs,
                     "artifact": buf.getvalue()})

    @staticmethod
    def deserialize(blob: bytes) -> "Plan":
        msg = unpack(blob)
        artifact = bytes(msg["artifact"])
        if not artifact.startswith(_ZIP_MAGIC):  # torch.export.save writes a zip archive
            raise ValueError(
                f"plan {msg.get('name')!r} is not a torch.export artifact: a JAX plan "
                "(jax.export StableHLO) cannot run in primia_tpu_torch")
        return Plan(torch.export.load(io.BytesIO(artifact)), msg["name"], int(msg["n_inputs"]))

    def run_flat(self, flat_inputs: List[np.ndarray]) -> List[np.ndarray]:
        if len(flat_inputs) != self.n_inputs:
            raise ValueError(
                f"plan {self.name!r} expects {self.n_inputs} inputs, "
                f"got {len(flat_inputs)}")
        args = [_tensor(a).to(d) for a, d in zip(flat_inputs, self._devices)]
        with torch.no_grad():
            outs = self._module(*args)
        return [o.detach().cpu().numpy() for o in leaves(outs)]

    def __call__(self, *args):
        outs = self.run_flat(leaves(list(args)))
        return outs[0] if len(outs) == 1 else outs


class Protocol:
    """A multi-role computation: an ordered pipeline of (role, Plan)
    (reference ``syft/execution/protocol.py:337``). Deployment maps roles
    to nodes; ``run`` executes each stage remotely through the grid's
    ``run_plan`` verb, so only the intermediate flat arrays travel."""

    def __init__(self, name: str, stages: Sequence[tuple]):
        self.name = name
        self.stages = list(stages)
        if not self.stages:
            raise ValueError("a Protocol needs at least one (role, plan) stage")
        self.assignments: dict = {}

    @property
    def roles(self) -> List[str]:
        return [r for r, _ in self.stages]

    def serialize(self) -> bytes:
        return pack({
            "name": self.name,
            "stages": [{"role": r, "plan": p.serialize()}
                       for r, p in self.stages],
        })

    @staticmethod
    def deserialize(blob: bytes) -> "Protocol":
        msg = unpack(blob)
        return Protocol(msg["name"], [
            (s["role"], Plan.deserialize(s["plan"])) for s in msg["stages"]])

    def deploy(self, grid, assignments: dict) -> "Protocol":
        """Host each role's plan on its assigned node (``{role: node_id}``)."""
        missing = set(self.roles) - set(assignments)
        if missing:
            raise ValueError(f"unassigned roles: {sorted(missing)}")
        for role, plan in self.stages:
            grid.serve_plan(assignments[role], plan)
        self.assignments = dict(assignments)
        return self

    def run(self, grid, *args):
        """Execute the pipeline across the deployed workers: stage i's flat
        outputs are stage i+1's inputs."""
        if not self.assignments:
            raise RuntimeError(f"protocol {self.name!r} is not deployed")
        flat = [np.asarray(a) for a in leaves(list(args))]
        for role, plan in self.stages:
            out = grid.run_remote_plan(self.assignments[role], plan.name, *flat)
            flat = out if isinstance(out, list) else [out]
        return flat[0] if len(flat) == 1 else flat

    def run_local(self, *args):
        """Execute all stages in-process."""
        flat = [np.asarray(a) for a in leaves(list(args))]
        for _, plan in self.stages:
            flat = plan.run_flat(flat)
        return flat[0] if len(flat) == 1 else flat
