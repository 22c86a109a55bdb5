"""Parallelism layer: federated simulation over N node replicas on one
card (port of ``primia_tpu/parallel``; the data-parallel and multi-host
modules are not ported yet)."""

from primia_tpu_torch.parallel.federated import main_federated, setup_federated  # noqa: F401
