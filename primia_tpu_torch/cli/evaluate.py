"""Eval CLI: ``python -m primia_tpu_torch.cli.evaluate``.

Port of ``primia_tpu/cli/evaluate.py``: loads a checkpoint (its stored
``args`` and ``val_mean_std``), runs the model over an image-folder test
set and prints the stats table (confusion matrix, per-class
recall/precision/F1, MCC, ROC-AUC). Runs on CUDA unless ``--device cpu``
(``--cuda``, the reference's flag, is ``--device cuda``).
The metrics are numpy only; the table needs tabulate.
"""

from __future__ import annotations

import argparse

import numpy as np

from primia_tpu_torch import DEVICES


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument(
        "--data_dir", type=str, required=True,
        help="Select a data folder.",
    )
    parser.add_argument(
        "--model_weights", type=str, required=True, help="model weights to use"
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


def main(argv=None):
    cmd_args = build_parser().parse_args(argv)

    from primia_tpu_torch import resolve_device
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.data import BatchLoader, ImageFolderDataset
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt
    from primia_tpu_torch.train import metrics as M
    from primia_tpu_torch.train.steps import build_predict_step

    device = resolve_device(cmd_args.device)
    state = ckpt.load_model(cmd_args.model_weights)
    args: Arguments = state["args"]
    args.from_previous_checkpoint(cmd_args)
    print(str(args))

    mean, std = state["val_mean_std"]
    channels = 1 if not args.pretrained else 3
    ds = ImageFolderDataset(cmd_args.data_dir, channels=channels)
    imgs, labels = ds.materialize(args.inference_resolution)

    model = create_model(args, num_classes=len(ds.classes), device=device)
    msd = state["model_state_dict"]
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    predict = build_predict_step(model, args, mean, std, device)

    loader = BatchLoader(imgs, labels, max(args.test_batch_size, 64), shuffle=False,
                         pad_final=True)
    preds, targets, scores = [], [], []
    for batch in loader:
        logits = predict(batch.images).cpu().numpy()
        keep = batch.mask > 0
        preds.append(logits[keep].argmax(1))
        scores.append(logits[keep])
        targets.append(batch.labels[keep])
    preds = np.concatenate(preds)
    targets = np.concatenate(targets)
    scores = np.concatenate(scores)

    m = M.evaluate_predictions(targets, preds, scores)
    table = M.stats_table(
        m["conf_matrix"], m["report"], roc_auc=m["roc_auc"],
        matthews_coeff=m["matthews_coeff"], class_names=ds.classes,
        epoch=int(state["epoch"]),
    )
    print(table)
    return m


if __name__ == "__main__":
    main()
