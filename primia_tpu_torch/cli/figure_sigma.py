"""Paper-figure sweep: secure-aggregation sync rate (sigma), on the port.

Port of ``figure_scripts/sigma.py``: re-run federated training at a
range of ``sync_every_n_batch`` values through
``primia_tpu_torch.train.loop.main``, append each run's best validation
objective (100 * Matthews coefficient) per sigma to a CSV in the working
directory, ``sigma_results.csv`` (the JAX script's header and row
layout, which its ``visualize_file`` renders), and render a summary
figure (mean and spread per sigma) with ``--visualize``. The CSV is read
with the ``csv`` module and matplotlib is imported only to draw.

    python -m primia_tpu_torch.cli.figure_sigma --num_runs 3 [--data_dir DIR]
        [--epochs 5] [--sigmas 1 2 3 5 10] [--device cpu]
    python -m primia_tpu_torch.cli.figure_sigma --visualize
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from pathlib import Path

from primia_tpu_torch.config import Arguments

RESULTS = "sigma_results.csv"


def writefile(file_name, input_dict: dict, headers: list) -> None:
    """Append one row (a value per header) to the CSV, writing the header
    first when the file is new."""
    file_exists = os.path.isfile(file_name)
    with open(file_name, "a" if file_exists else "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=[str(h) for h in headers])
        if not file_exists:
            writer.writeheader()
        writer.writerow({str(k): v for k, v in input_dict.items()})


def read_columns(file_name) -> dict:
    """{header: [values of its non-empty cells]}, headers in numeric order."""
    with open(file_name, newline="") as f:
        rows = list(csv.DictReader(f))
    heads = sorted(rows[0].keys() if rows else [], key=float)
    return {h: [float(r[h]) for r in rows if r.get(h) not in (None, "")] for h in heads}


def visualize_file(file_name, out_png=None, xlabel="value") -> str:
    """The mean and the min-max band of each column against its header;
    writes a PNG beside the CSV (or ``out_png``) and returns its path."""
    from matplotlib import pyplot as plt

    cols = read_columns(file_name)
    x = [float(h) for h in cols]
    means = [sum(v) / len(v) for v in cols.values()]
    mins = [min(v) for v in cols.values()]
    maxs = [max(v) for v in cols.values()]
    fig, ax = plt.subplots(figsize=(6, 3.5))
    ax.fill_between(x, mins, maxs, color="#2a78d6", alpha=0.18, linewidth=0)
    ax.plot(x, means, color="#2a78d6", linewidth=2, marker="o", markersize=5)
    ax.set_xlabel(xlabel, color="#52514e")
    ax.set_ylabel("best val Matthews coeff", color="#52514e")
    ax.grid(color="#e7e6e3", linewidth=0.8)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    fig.tight_layout()
    out = out_png or str(Path(file_name).with_suffix(".png"))
    fig.savefig(out, dpi=160)
    plt.close(fig)
    print(f"wrote {out}")
    return out


def base_args(cmd, sigma: int) -> Arguments:
    return Arguments(
        name="sigmafigure",
        train_federated=True,
        unencrypted_aggregation=cmd.unencrypted_aggregation,
        data_dir=cmd.data_dir,
        batch_size=cmd.batch_size,
        train_resolution=cmd.resolution,
        inference_resolution=cmd.resolution,
        test_batch_size=10,
        test_interval=1,
        epochs=cmd.epochs,
        lr=1e-4,
        end_lr=1e-5,
        beta1=0.5,
        beta2=0.99,
        model=cmd.model,
        pooling_type="max",
        sync_every_n_batch=sigma,
        repetitions_dataset=1,
        weighted_averaging=True,
        deterministic=False,
        save_file="",
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--sigmas", type=int, nargs="+", default=[1, 2, 3, 5, 10])
    p.add_argument("--data_dir", default="data/server_simulation")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--model", default="resnet-18")
    p.add_argument("--unencrypted_aggregation", action="store_true")
    p.add_argument("--device", default="cuda")
    cmd = p.parse_args(argv)

    if cmd.visualize:
        visualize_file(RESULTS, xlabel="sync_every_n_batch (sigma)")
        return 0

    from primia_tpu_torch.train.loop import main as train_main

    for _ in range(cmd.num_runs):
        row = {}
        for sigma in cmd.sigmas:
            row[sigma] = train_main(base_args(cmd, sigma), verbose=False, device=cmd.device)
            print(f"sigma={sigma}: best val MCC {row[sigma]:.4f}")
        writefile(RESULTS, row, cmd.sigmas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
