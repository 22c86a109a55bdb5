"""Inference CLI: ``python -m primia_tpu_torch.cli.inference``.

Port of the plain path of ``primia_tpu/cli/inference.py``: loads a
checkpoint (its ``args`` and ``val_mean_std``), classifies every image in
``--data_dir`` and writes ``{"Inference Results": {index: prediction}}``
as JSON to stdout, then the class counts and the wall-clock time. Runs
on CUDA unless ``--device cpu`` (``--cuda``, the reference's flag, is
``--device cuda``). ``--encrypted_inference`` runs the forward over secret
shares (``mpc/inference.py``: two computing parties and the dealer
simulated on the device, fixed point in Z_{2^64}, batch norm folded and
group norm private); ``--protocol`` picks its comparison, ``fss`` (the
DCF comparison on kernel K4, the default here) or ``snn`` (SecureNN). The
output contract is the same. Remote inference (``--websockets_config``,
``--http_protocol``) is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter

from primia_tpu_torch import DEVICES


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", default=None, help="data to classify")
    parser.add_argument(
        "--model_weights", type=str, required=True, help="model weights to use"
    )
    parser.add_argument(
        "--encrypted_inference", action="store_true",
        help="Perform encrypted inference",
    )
    parser.add_argument(
        "--protocol", type=str, default="fss", choices=("snn", "fss"),
        help="MPC comparison protocol for encrypted inference: fss (the DCF "
        "comparison, kernel K4) or snn (SecureNN)",
    )
    parser.add_argument(
        "--batch_size", type=int, default=1,
        help="Images per forward pass (the reference runs 1).",
    )
    parser.add_argument(
        "--mpc_batch_tile", type=int, default=None,
        help="Encrypted path: run the share-space forward this many images "
        "at a time (each tile with its own dealer stream), bounding the live "
        "dealer material. Default: the whole batch at once.",
    )
    parser.add_argument(
        "--device", choices=DEVICES, default="cuda",
        help="Where to run (default cuda; without a card it raises).",
    )
    parser.add_argument(
        "--cuda", dest="device", action="store_const", const="cuda",
        help="The reference's flag: the same as --device cuda.",
    )
    return parser


def run(cmd_args) -> dict:
    import numpy as np

    from primia_tpu_torch import resolve_device
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import PathDataset
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train.steps import build_predict_step

    device = resolve_device(cmd_args.device)
    state = ckpt.load_model(cmd_args.model_weights)
    args: Arguments = state["args"]
    args.from_previous_checkpoint(cmd_args)
    sys.stderr.write(str(args))

    mean, std = state["val_mean_std"]
    channels = 1 if not args.pretrained else 3
    class_names = {0: "normal", 1: "bacterial pneumonia", 2: "viral pneumonia"}

    dataset = PathDataset(cmd_args.data_dir, channels=channels)
    imgs, _ = dataset.materialize(args.inference_resolution)

    model = create_model(args, num_classes=len(class_names), device=device)
    msd = state["model_state_dict"]
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    if cmd_args.encrypted_inference:
        from primia_tpu_torch.mpc.inference import build_encrypted_predict

        predict = build_encrypted_predict(
            model, args, mean, std, device,
            precision_fractional=args.precision_fractional or 16,
            protocol=cmd_args.protocol, batch_tile=cmd_args.mpc_batch_tile)
    else:
        predict = build_predict_step(model, args, mean, std, device)

    B = max(int(cmd_args.batch_size), 1)
    total_pred = []
    for i in range(0, len(imgs), B):
        chunk = imgs[i : i + B]
        n = len(chunk)
        if n < B:  # pad to the batch shape
            chunk = np.concatenate([chunk, np.zeros((B - n, *chunk.shape[1:]), chunk.dtype)])
        logits = predict(chunk)[:n]
        total_pred.extend(int(p) for p in logits.argmax(1).cpu())
    return {"Inference Results": dict(enumerate(total_pred))}


def main(argv=None):
    tick = time.time()
    cmd_args = build_parser().parse_args(argv)
    pred_dict = run(cmd_args)
    sys.stdout.write(json.dumps(pred_dict))
    print("\n{:s}".format(str(Counter(pred_dict["Inference Results"].values()))))
    tock = time.time()
    print()
    print(f"Took {tock-tick} seconds.")
    return pred_dict


if __name__ == "__main__":
    main()
