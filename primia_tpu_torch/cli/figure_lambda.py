"""Paper-figure sweep: MixUp lambda, on the port.

Port of ``figure_scripts/lambda.py``: re-run local training through
``primia_tpu_torch.train.loop.main`` at a range of fixed
``mixup_lambda`` values, append each run's best validation objective
(100 * Matthews coefficient) per lambda to ``lambda_results.csv`` in the
working directory (the JAX script's layout), render with
``--visualize``.

    python -m primia_tpu_torch.cli.figure_lambda --num_runs 3 [--data_dir DIR]
        [--epochs 5] [--device cpu]
    python -m primia_tpu_torch.cli.figure_lambda --visualize
"""

from __future__ import annotations

import argparse
import sys

from primia_tpu_torch.cli.figure_sigma import visualize_file, writefile
from primia_tpu_torch.config import Arguments

RESULTS = "lambda_results.csv"
LAMBDAS = [0.0, 0.1, 0.25, 0.5, 0.75, 0.9, 1.0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--visualize", action="store_true")
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--lambdas", type=float, nargs="+", default=LAMBDAS)
    p.add_argument("--data_dir", default="data/server_simulation/worker1")
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--resolution", type=int, default=224)
    p.add_argument("--model", default="resnet-18")
    p.add_argument("--device", default="cuda")
    cmd = p.parse_args(argv)

    if cmd.visualize:
        visualize_file(RESULTS, xlabel="mixup lambda")
        return 0

    from primia_tpu_torch.train.loop import main as train_main

    for _ in range(cmd.num_runs):
        row = {}
        for lam in cmd.lambdas:
            args = Arguments(
                name="lambdafigure",
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
                mixup=True,
                mixup_prob=0.9,
                mixup_lambda=lam,
                deterministic=False,
                save_file="",
            )
            row[lam] = train_main(args, verbose=False, device=cmd.device)
            print(f"lambda={lam}: best val MCC {row[lam]:.4f}")
        writefile(RESULTS, row, cmd.lambdas)
    return 0


if __name__ == "__main__":
    sys.exit(main())
