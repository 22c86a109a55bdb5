"""Training CLI: ``python -m primia_tpu_torch.cli.train``.

Port of ``primia_tpu/cli/train.py``, flag-compatible with it (and with the
reference ``train.py:555-631``), plus ``--device``::

    python -m primia_tpu_torch.cli.train --config configs/torch/pneumonia-resnet-pretrained.ini \\
        --data_dir data/train [--device cuda|cpu]

Runs on CUDA unless ``--device cpu``. Single-site training is ported;
``--train_federated`` (slice 4) and DP configs (slice 5) raise
``NotImplementedError``.
"""

from __future__ import annotations

import argparse
from os import path

from primia_tpu_torch import DEVICES
from primia_tpu_torch.config import Arguments


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True,
                        help="Path to the configuration file (.ini).")
    parser.add_argument("--train_federated", action="store_true",
                        help="Train with federated learning (not ported yet).")
    parser.add_argument("--unencrypted_aggregation", action="store_true",
                        help="Turns off secure aggregation (federated only).")
    parser.add_argument("--data_dir", type=str, default="data/train",
                        help="Select a data folder.")
    parser.add_argument("--visdom", action="store_true",
                        help="Use live monitoring of training (JSON lines + HTML).")
    parser.add_argument("--cuda", action="store_true",
                        help="Accepted for reference CLI parity; use --device.")
    parser.add_argument("--resume_checkpoint", type=str, default=None,
                        help="Start training from older model checkpoint")
    parser.add_argument("--websockets", action="store_true",
                        help="Train against remote grid nodes (federated only).")
    parser.add_argument("--verbose", action="store_true",
                        help="Verbose worker/metric output")
    parser.add_argument("--save_file", type=str,
                        default="model_weights/completed_trainings.csv",
                        help="Store args and result in csv file.")
    parser.add_argument("--training_name", default=None, type=str,
                        help="Optional name to be stored in csv file to later identify "
                        "training.")
    parser.add_argument("--device", choices=DEVICES, default="cuda",
                        help="Where to run (default cuda; without a card it raises).")
    return parser


def main(argv=None) -> float:
    cmd_args = build_parser().parse_args(argv)
    if not path.isfile(cmd_args.config):
        raise FileNotFoundError(f"Configuration file not found: {cmd_args.config}")
    args = Arguments.from_ini(cmd_args.config, mode="train", cmd_args=cmd_args, verbose=True)
    if args.websockets and not args.train_federated:
        raise RuntimeError("WebSockets can only be used when in federated mode.")
    print(str(args))

    from primia_tpu_torch.train.loop import main as train_main

    return train_main(args, device=cmd_args.device)


if __name__ == "__main__":
    main()
