"""Node-fleet launcher (reference ``torchlib/run_websocket_server.py``).

Port of ``primia_tpu/serve/launcher.py``: one ``python -m
primia_tpu_torch.serve.node`` process a row of a worker-topology CSV
(``configs/websetting/config.csv``), each on ``--device`` (default cuda),
with SIGINT/SIGTERM teardown::

    python -m primia_tpu_torch.serve.launcher --config <csv> --data_root <dir> \\
        [--ini <train ini>] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import signal
import subprocess
import sys
import time
from pathlib import Path

from primia_tpu_torch import DEVICES
from primia_tpu_torch.config import read_worker_config


def launch_nodes(csv_path, data_root=None, ini_config=None, wait: bool = True,
                 device: str = "cuda"):
    cfg = read_worker_config(csv_path)
    procs = []
    for i, (wid, w) in enumerate(cfg.items()):
        cmd = [
            sys.executable, "-m", "primia_tpu_torch.serve.node",
            "--id", wid, "--host", w["host"], "--port", str(w["port"]),
            "--device", device,
        ]
        if data_root and wid != "crypto_provider":
            d = Path(data_root) / (wid if (Path(data_root) / wid).is_dir()
                                   else f"worker{i + 1}")
            if d.is_dir():
                cmd += ["--data_directory", str(d)]
        if ini_config:
            cmd += ["--config", str(ini_config)]
        procs.append(subprocess.Popen(cmd))
    if not wait:
        return procs

    def shutdown(sig, frame):
        for p in procs:
            p.terminate()
        sys.exit(0)

    # SIGTERM too: a plain `kill` of the launcher must not orphan the fleet
    signal.signal(signal.SIGINT, shutdown)
    signal.signal(signal.SIGTERM, shutdown)
    while True:
        time.sleep(1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", required=True, help="worker topology csv")
    parser.add_argument("--data_root", default=None)
    parser.add_argument("--ini", default=None, help="training ini for resolutions")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="Where every node computes (default cuda).")
    a = parser.parse_args(argv)
    launch_nodes(a.config, a.data_root, a.ini, device=a.device)


if __name__ == "__main__":
    main()
