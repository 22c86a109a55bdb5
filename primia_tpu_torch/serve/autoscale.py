"""Cluster provisioning helpers (gcloud / Terraform artifact generation).

Port of ``primia_tpu/serve/autoscale.py`` (reference
``syft/grid/utils/autoscale/``): command and configuration text only;
nothing is executed unless ``AutoScaler(execute=True)`` asks for it. The
compute machine is an A3 instance with one H100 (the JAX package's is a
TPU VM slice), the grid nodes are ordinary VMs that run ``python -m
primia_tpu_torch.serve.node``, and the worker-topology CSV is the one the
federated CLI reads (``configs/websetting/config.csv``).
"""

from __future__ import annotations

import shlex
import subprocess
from pathlib import Path
from typing import Dict, List, NamedTuple


class ClusterSpec(NamedTuple):
    """What to provision (reference autoscale's cluster definition)."""

    name: str = "primia"
    project: str = "my-project"
    zone: str = "us-central2-b"
    accelerator_type: str = "nvidia-h100-80gb"  # the compute machine's card
    machine_type: str = "a3-highgpu-1g"
    image_family: str = "common-cu128-ubuntu-2204-nvidia-570"
    n_grid_nodes: int = 3  # hospital/data-owner nodes
    node_machine_type: str = "n2-standard-8"
    base_port: int = 8777
    with_crypto_provider: bool = True


def node_names(spec: ClusterSpec) -> List[str]:
    names = [f"{spec.name}-node-{i + 1}" for i in range(spec.n_grid_nodes)]
    if spec.with_crypto_provider:
        names.append(f"{spec.name}-crypto-provider")
    return names


def gcloud_commands(spec: ClusterSpec) -> List[str]:
    """Provisioning command lines: one GPU machine + one VM per grid
    node + a firewall rule for the node RPC ports."""
    cmds = [
        f"gcloud compute instances create {spec.name}-mesh"
        f" --project={spec.project} --zone={spec.zone}"
        f" --machine-type={spec.machine_type}"
        f" --accelerator=type={spec.accelerator_type},count=1"
        f" --image-family={spec.image_family} --image-project=deeplearning-platform-release"
        f" --maintenance-policy=TERMINATE",
    ]
    for name in node_names(spec):
        cmds.append(
            f"gcloud compute instances create {name}"
            f" --project={spec.project} --zone={spec.zone}"
            f" --machine-type={spec.node_machine_type}"
            f" --metadata=startup-script='pip install primia-tpu &&"
            f" python -m primia_tpu_torch.serve.node --id {name}"
            f" --port {spec.base_port} --device cpu'"
        )
    hi = spec.base_port + len(node_names(spec)) + 1000  # ws + HTTP fallback
    cmds.append(
        f"gcloud compute firewall-rules create {spec.name}-grid-rpc"
        f" --project={spec.project}"
        f" --allow=tcp:{spec.base_port}-{hi}"
        f" --target-tags={spec.name}-grid"
    )
    return cmds


def teardown_commands(spec: ClusterSpec) -> List[str]:
    """The destroy phase (reference autoscale's delete path)."""
    cmds = [
        f"gcloud compute instances delete {spec.name}-mesh"
        f" --project={spec.project} --zone={spec.zone} --quiet"
    ]
    for name in node_names(spec):
        cmds.append(
            f"gcloud compute instances delete {name}"
            f" --project={spec.project} --zone={spec.zone} --quiet")
    cmds.append(
        f"gcloud compute firewall-rules delete {spec.name}-grid-rpc"
        f" --project={spec.project} --quiet")
    return cmds


def terraform_config(spec: ClusterSpec) -> str:
    """Equivalent Terraform HCL (the reference wraps terraform via
    python-terraform; plain HCL is toolchain-neutral)."""
    blocks = [
        f'''provider "google" {{
  project = "{spec.project}"
  zone    = "{spec.zone}"
}}

resource "google_compute_instance" "{spec.name}_mesh" {{
  name         = "{spec.name}-mesh"
  machine_type = "{spec.machine_type}"
  zone         = "{spec.zone}"
  guest_accelerator {{
    type  = "{spec.accelerator_type}"
    count = 1
  }}
  scheduling {{ on_host_maintenance = "TERMINATE" }}
  boot_disk {{
    initialize_params {{ image = "deeplearning-platform-release/{spec.image_family}" }}
  }}
  network_interface {{ network = "default" }}
}}'''
    ]
    for name in node_names(spec):
        rname = name.replace("-", "_")
        blocks.append(f'''resource "google_compute_instance" "{rname}" {{
  name         = "{name}"
  machine_type = "{spec.node_machine_type}"
  zone         = "{spec.zone}"
  tags         = ["{spec.name}-grid"]
  boot_disk {{
    initialize_params {{ image = "debian-cloud/debian-12" }}
  }}
  network_interface {{
    network = "default"
    access_config {{}}
  }}
  metadata_startup_script = "pip install primia-tpu && python -m primia_tpu_torch.serve.node --id {name} --port {spec.base_port} --device cpu"
}}''')
    return "\n\n".join(blocks) + "\n"


def worker_config_csv(spec: ClusterSpec, hosts: Dict[str, str] | None = None) -> str:
    """The ``configs/websetting/config.csv`` this cluster serves —
    what ``train.py --train_federated`` consumes. ``hosts`` maps node
    name -> address once provisioning assigned IPs (placeholder
    hostnames otherwise)."""
    names = node_names(spec)
    ids = [f"worker{i + 1}" for i in range(spec.n_grid_nodes)]
    if spec.with_crypto_provider:
        ids.append("crypto_provider")
    hostrow = [(hosts or {}).get(n, f"{n}.{spec.zone}.c.{spec.project}.internal")
               for n in names]
    ports = [str(spec.base_port + i) for i in range(len(names))]
    return "\n".join([
        "id," + ",".join(ids),
        "host," + ",".join(hostrow),
        "port," + ",".join(ports),
    ]) + "\n"


class AutoScaler:
    """Two-phase provision/destroy runner (reference autoscale API:
    create -> use -> destroy). ``execute=False`` (default) is plan-only."""

    def __init__(self, spec: ClusterSpec, execute: bool = False):
        self.spec = spec
        self.execute = execute

    def _run(self, cmds: List[str]) -> List[str]:
        if self.execute:
            for c in cmds:
                subprocess.run(shlex.split(c), check=True)
        return cmds

    def create_cluster(self) -> List[str]:
        return self._run(gcloud_commands(self.spec))

    def destroy_cluster(self) -> List[str]:
        return self._run(teardown_commands(self.spec))

    def write_artifacts(self, outdir) -> Dict[str, Path]:
        """provision.sh / teardown.sh / main.tf / config.csv"""
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        files = {
            "provision.sh": "#!/bin/sh\nset -e\n" + "\n".join(
                gcloud_commands(self.spec)) + "\n",
            "teardown.sh": "#!/bin/sh\n" + "\n".join(
                teardown_commands(self.spec)) + "\n",
            "main.tf": terraform_config(self.spec),
            "config.csv": worker_config_csv(self.spec),
        }
        paths = {}
        for fn, content in files.items():
            p = out / fn
            p.write_text(content)
            if fn.endswith(".sh"):
                p.chmod(0o755)
            paths[fn] = p
        return paths
