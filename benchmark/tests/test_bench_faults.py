"""A run with its timed path broken underneath comes out not correct.

Each test drives the rest of a run (``benchmark.run.execute`` on a cell cut
to the CPU's size, the look for a card skipped) with one fault planted in
the program: a step that leaves the state unchanged, a step that climbs
the loss (its change reversed, which a gap of norms cannot see), the loss
over half of the batch, and an answer altered where it is produced (a train step's
loss, a request's logits). The cells run on one chip, so no exchange
between chips can be left out. The encrypted cells wait outside
BENCHMARK.json for a fault of the program (PERF.md); their harness is
held here all the same.
"""

import time

import pytest
import torch

from benchmark import run
from benchmark.tests.small import small_cell


def _run(workload, **kw):
    cell = small_cell(workload, **kw)
    seconds = 0.002 if "encrypted" in workload else 0.5
    return run.execute(workload, 2 ** 35 + 3, seconds, False, device="cpu", cell=cell,
                       setup_started=time.perf_counter())


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
def test_a_sound_train_run_is_correct(workload):
    assert _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(workload, monkeypatch):
    from primia_tpu_torch.train import optim

    monkeypatch.setattr(optim.Adam, "update", lambda self, grads, lr: None)
    out = _run(workload)
    assert not out["correct"] and out["compared"]["update_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
def test_an_ascent_is_caught(workload, monkeypatch):
    from primia_tpu_torch.train import optim

    descend = optim.Adam.update

    def ascend(self, grads, lr):
        before = [p.detach().clone() for p in self.params]
        descend(self, grads, lr)
        with torch.no_grad():
            for p, b in zip(self.params, before):
                p.copy_(2 * b - p)

    monkeypatch.setattr(optim.Adam, "update", ascend)
    out = _run(workload)
    assert out["compared"]["update_gap"]["value"] < out["compared"]["update_gap"]["limit"]
    assert not out["correct"] and out["compared"]["update_dir_median"]["value"] > 1.5


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
def test_a_loss_over_half_the_batch_is_caught(workload, monkeypatch):
    from primia_tpu_torch.train import losses

    whole = losses.cross_entropy_one_hot

    def half(logits, target, weight=None, reduction="mean", sample_mask=None):
        n = logits.shape[0] // 2
        return whole(logits[:n], target[:n], weight, reduction, sample_mask[:n])

    monkeypatch.setattr(losses, "cross_entropy_one_hot", half)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("workload", ["resnet18.train", "vgg16.train"])
def test_an_altered_loss_is_caught(workload, monkeypatch):
    from primia_tpu_torch.train import steps

    build = steps.build_train_step

    def altered(*a, **kw):
        step = build(*a, **kw)
        return lambda *args: step(*args) * 1.1

    monkeypatch.setattr(steps, "build_train_step", altered)
    out = _run(workload)
    assert not out["correct"] and out["compared"]["loss1_gap"]["value"] > 0.09


def _patch_predict(monkeypatch, change):
    from primia_tpu_torch.mpc import inference

    build = inference.build_encrypted_predict

    def broken(*a, **kw):
        predict = build(*a, **kw)
        return lambda images: change(images, predict)

    monkeypatch.setattr(inference, "build_encrypted_predict", broken)


def test_an_altered_logit_is_caught(monkeypatch):
    def change(images, predict):
        out = predict(images).clone()
        out[0, 0] += 0.1 * out.abs().max()
        return out

    _patch_predict(monkeypatch, change)
    assert not _run("resnet18.encrypted_fss", per=2)["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    def change(images, predict):
        n = images.shape[0] // 2
        out = predict(images[:n])
        return torch.cat([out, out.mean(0, keepdim=True).expand(images.shape[0] - n, -1)])

    _patch_predict(monkeypatch, change)
    assert not _run("resnet18.encrypted_fss", per=2)["correct"]
