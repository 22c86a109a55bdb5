"""The plain reference against the port at a tiny size on the CPU: the
augmentation chain and MixUp draw for draw, the forward passes, the
first train step, and the encrypted fss predict; and a cell on the card
(``cuda``)."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import calibrate, common
from benchmark.drivers import train as train_driver
from benchmark.reference import augment as RA
from benchmark.reference import models as RM
from benchmark.tests.small import small_cell


def _program_model(cfg, seed=3):
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model

    args = Arguments.from_dict(cfg["args"])
    model = create_model(args, num_classes=3, device="cpu")
    W, B = common.make_weights(torch.Generator().manual_seed(seed), model)
    common.load_into(model, W, B)
    return args, model, W, B


def test_augmentation_and_mixup_draw_as_the_program_does():
    from primia_tpu_torch.ops.augment import AugmentConfig, build_augment_fn
    from primia_tpu_torch.train import losses

    _, cfg, _, _ = small_cell("resnet18.train", res=48, batch=6)
    args, _, _, _ = _program_model(cfg)
    u8, labels = common.make_images(torch.Generator().manual_seed(5), 6, 48)
    mean, std = common.mean_std(u8)
    prog = build_augment_fn(AugmentConfig.from_args(args), mean, std, 3, "cpu")
    g1, g2 = torch.Generator().manual_seed(11), torch.Generator().manual_seed(11)
    x_p = prog(g1, u8)
    x_r = RA.augment(g2, u8, cfg["args"], torch.tensor(mean), torch.tensor(std))
    assert torch.allclose(x_p, x_r, atol=1e-5, rtol=0)
    y = torch.nn.functional.one_hot(labels, 3).float()
    xm_p, ym_p = losses.mixup(g1, x_p, y, prob=0.9)
    xm_r, ym_r = RA.mixup(g2, x_r, y, 0.9)
    assert torch.allclose(xm_p, xm_r, atol=1e-5, rtol=0) and torch.equal(ym_p, ym_r)


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_the_program_model(workload, train):
    _, cfg, _, _ = small_cell(workload)
    _, model, W, B = _program_model(cfg)
    x = torch.randn(4, 3, 32, 32, generator=torch.Generator().manual_seed(1))
    model.train(train)
    with torch.no_grad():
        want = model(x.contiguous(memory_format=torch.channels_last))
        got = RM.forward(W, B, x, cfg["architecture"], train=train)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))


def test_first_train_step_matches_the_reference():
    entry, cfg, traffic, limits = small_cell("resnet18.train")
    run = train_driver.Run(cfg, traffic, 2 ** 40 + 7, "cpu")
    run.setup()
    run.release()
    ref = run.reference()
    assert run.losses[0] == pytest.approx(ref["losses"][0], rel=1e-5)
    assert run.readings(ref)["grad_gap"] < 1e-3


def test_encrypted_predict_matches_the_reference():
    w = "resnet18.encrypted_fss"
    r = calibrate.readings(w, 2 ** 33 + 5, "cpu", small_cell(w, per=2), units=1)
    # 16 fractional bits: at 32 px the logits' gap is a few thousandths of
    # the largest (at 224 px on the card, under one, PERF.md)
    assert r["program"]["logit_gap"] < 1e-2
    assert r["where"]["requests"] == 1 and not r["where"]["off_by_over_scale"]


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "resnet18.train", "--seed", "77", "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=common.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["train_step_mfu"]["value"])
