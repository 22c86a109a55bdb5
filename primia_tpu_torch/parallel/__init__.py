"""Parallelism layer (port of ``primia_tpu/parallel``): federated
simulation over N node replicas on one card, and runs over ranks of
``torch.distributed`` (``multihost``, ``data_parallel``, the rank
launcher ``launch``)."""

from primia_tpu_torch.parallel.federated import main_federated, setup_federated  # noqa: F401
