"""Pre-warm a training config: ``python -m primia_tpu_torch.cli.warm``.

Port of ``primia_tpu/cli/warm.py``. The JAX package fills the persistent
XLA compilation cache; the port has no such cache. Its persistent
artefacts are the CUDA kernel libraries that ``ops/_build.py`` compiles
with ``nvcc`` into ``build/primia_tpu_torch/`` at first use. So this tool
builds every ``csrc/*.cu`` (all at once, as ``_build.build`` does), then
runs the config's train step once (the DP-SGD step under
``differentially_private``) at ``batch_size`` and its eval step once at
``max(test_batch_size, 64)``, at the config's resolution on random uint8
input, as the JAX tool lowers them: the datasets are read, their
normalisation statistics and class weights computed, as the train CLI
does. It prints one line a program with its seconds and writes no
weights::

    python -m primia_tpu_torch.cli.warm --config <ini> --data_dir <dir> [--device cuda|cpu]

On the CPU (``--device cpu``) nothing is compiled and the steps run their
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import time

from primia_tpu_torch import DEVICES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True, help="INI config path")
    p.add_argument("--data_dir", required=True, help="training data folder (or 'mnist')")
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="Where to run (default cuda; without a card it raises).")
    return p


def main(argv=None) -> int:
    cmd = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from primia_tpu_torch import resolve_device
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.ops import _build
    from primia_tpu_torch.train.dp import select_train_step
    from primia_tpu_torch.train.loop import load_train_val
    from primia_tpu_torch.train.losses import calc_class_weights
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_eval_step

    device = resolve_device(cmd.device)
    args = Arguments.from_ini(cmd.config, mode="train")
    args.data_dir = cmd.data_dir

    n = 0
    if device.type == "cuda":
        t0 = time.perf_counter()
        libs = _build.build()
        n += len(libs)
        print(f"kernels built: {len(libs)} libraries in {_build.BUILD_DIR} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    (train_imgs, train_labels, _val_imgs, _val_labels, mean, std,
     class_names) = load_train_val(args)
    nc = len(class_names)
    torch.manual_seed(args.seed)
    model = create_model(args, num_classes=nc, device="cpu").to(device)
    opt = make_optimizer(args, model)
    cw = calc_class_weights(train_labels, nc) if args.weight_classes else None
    train_step = select_train_step(model, opt, args, mean, std, cw, device)
    eval_step = build_eval_step(model, args, mean, std, cw, device)

    res, C = args.inference_resolution, model.in_channels
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def batch(b):
        img = torch.randint(0, 256, (b, res, res, C), dtype=torch.uint8, device=device,
                            generator=gen)
        lab = torch.randint(0, nc, (b,), device=device, generator=gen).int()
        return img, lab, torch.ones(b, dtype=torch.float32, device=device)

    def run(name, fn):
        t0 = time.perf_counter()
        out = fn()
        loss = float(out[0] if isinstance(out, tuple) else out)  # waits for the device
        if not np.isfinite(loss):
            raise RuntimeError(f"{name}: non-finite loss {loss}")
        print(f"{name} ran ({time.perf_counter() - t0:.1f}s)", flush=True)

    run("train step", lambda: train_step(gen, *batch(args.batch_size), 1e-4))
    run("eval step", lambda: eval_step(*batch(max(args.test_batch_size, 64))))
    print(f"warm: {n} kernel libraries built, 2 programs run")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
