"""The port's hyperparameter search against the JAX package: the study, the
trial's ``Arguments``, the CLI with pruning in both train loops, and the
background checkpoint writer, on the CPU.

The study is pure Python on ``random.Random``, so it is held bit for bit:
the same seed and reported values give the same parameters, prune
decisions and JSON file, and each package resumes the other's file.
``build_args`` gives the same ``to_json()`` for the same draws. The CLI
runs ResNet-18 at 32 px without pretrained weights; a trial is pruned
through the loop's hook by seeding the study's storage with finished
trials whose intermediate values are high. The writer's files are held
byte for byte to a synchronous save.
"""

import argparse
import json
import threading
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch

from primia_tpu.cli.find_config import build_args as jax_build_args
from primia_tpu.train.hpo import Study as JaxStudy
from primia_tpu.train.hpo import TrialPruned as JaxTrialPruned
from primia_tpu_torch.cli import find_config
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import to_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train import loop
from primia_tpu_torch.train.hpo import Study, TrialPruned
from primia_tpu_torch.train.optim import make_optimizer

CLASSES = ("bacterial pneumonia", "normal", "viral pneumonia")


@pytest.fixture(autouse=True)
def _one_intra_op_thread(monkeypatch):
    """Under the suite's parallel workers, intra-op threads only wait on
    each other, so each test runs on one."""
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objective(trial, prune):
    """Suggests every kind of parameter and reports five steps."""
    x = trial.suggest_float("x", -10, 10)
    lr = trial.suggest_loguniform("lr", 1e-5, 1e-3)
    k = trial.suggest_int("k", 0, 7)
    c = trial.suggest_categorical("c", ["a", "b", True])
    base = -(x - 3.0) ** 2 + k + (1.0 if c is True else 0.0) + lr
    for step in range(1, 6):
        trial.report(base + 0.1 * step, step)
        if trial.should_prune():
            raise prune()
    return base


def _run(study_cls, prune, path, n, seed):
    study = study_cls(str(path), n_startup=4, n_warmup_steps=2, seed=seed)
    study.optimize(partial(_objective, prune=prune), n)
    return study


def test_study_is_bit_for_bit_the_jax_study_and_resumes_its_file(tmp_path):
    got = _run(Study, TrialPruned, tmp_path / "port.json", 14, seed=3)
    want = _run(JaxStudy, JaxTrialPruned, tmp_path / "jax.json", 14, seed=3)
    assert [t.__dict__ for t in got.trials] == [t.__dict__ for t in want.trials]
    assert {t.state for t in got.trials} == {"complete", "pruned"}
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    # each package goes on from the other's file as the other does
    for path in ("port.json", "jax.json"):
        (tmp_path / f"x_{path}").write_text((tmp_path / path).read_text())
    more = _run(Study, TrialPruned, tmp_path / "x_jax.json", 6, seed=4)
    more_jax = _run(JaxStudy, JaxTrialPruned, tmp_path / "x_port.json", 6, seed=4)
    assert len(more.trials) == 20
    assert [t.__dict__ for t in more.trials] == [t.__dict__ for t in more_jax.trials]
    assert more.best_trial.__dict__ == more_jax.best_trial.__dict__


def _cmdln(federated):
    return argparse.Namespace(
        federated=federated, unencrypted_aggregation=federated, websockets=False,
        data_dir="data/server_simulation", epochs=24, batch_size=8, resolution=32,
        model="resnet-18", pretrained=False)


@pytest.mark.parametrize("federated", [False, True])
def test_build_args_gives_the_jax_arguments(tmp_path, federated):
    """Past ``n_startup`` the draws perturb the best trials' parameters;
    both studies see the same told values."""
    ports = Study(str(tmp_path / "p.json"), n_startup=3, seed=7)
    jaxs = JaxStudy(str(tmp_path / "j.json"), n_startup=3, seed=7)
    seen_albu = set()
    for i in range(12):
        tp, tj = ports.ask(), jaxs.ask()
        a = find_config.build_args(tp, _cmdln(federated))
        b = jax_build_args(tj, _cmdln(federated))
        assert a.to_json() == b.to_json()
        assert tp.params == tj.params
        seen_albu.add(tp.params["apply albu transforms"])
        ports.tell(tp, float(i % 5))
        jaxs.tell(tj, float(i % 5))
    assert seen_albu == {True, False}
    assert isinstance(a, Arguments)


def _fixture(root: Path, per_class=4):
    from PIL import Image

    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for ci, cls in enumerate(CLASSES):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(per_class):
                arr = rng.integers(0, 80, (40, 40), dtype=np.uint8) + 40 + 60 * ci
                Image.fromarray(arr, mode="L").save(d / f"{i}.jpeg")
    return root


def _fed_fixture(root: Path):
    from PIL import Image

    rng = np.random.default_rng(1)
    for folder, n in (("worker1", 4), ("worker2", 3), ("worker3", 2), ("validation", 3)):
        for ci, cls in enumerate(CLASSES):
            d = root / folder / cls
            d.mkdir(parents=True)
            for i in range(n):
                arr = rng.integers(0, 80, (32, 32), dtype=np.uint8) + 40 + 60 * ci
                Image.fromarray(arr, mode="L").save(d / f"{i}.jpeg")
    return root


def _writer_threads():
    return {t for t in threading.enumerate() if t.name.startswith("ThreadPoolExecutor")}


def test_find_config_cli_prunes_through_the_loop_and_trains_federated(tmp_path, monkeypatch,
                                                                      capsys):
    data = _fixture(tmp_path / "xray")
    fed = _fed_fixture(tmp_path / "fed")
    monkeypatch.chdir(tmp_path)
    storage = tmp_path / "model_weights" / "study.json"
    storage.parent.mkdir()
    # five finished trials at step 5 (the default pruner's warm-up) above
    # any objective this run reaches: the median prunes the first trial there
    storage.write_text(json.dumps({"trials": [
        {"number": i, "params": {}, "intermediate": {"5": 100.0}, "value": 100.0,
         "state": "complete"} for i in range(5)]}))
    monkeypatch.setattr(find_config, "Study", partial(Study, seed=0))
    common = ["--batch_size", "12", "--resolution", "32", "--no-pretrained",
              "--storage", str(storage), "--device", "cpu"]
    before = _writer_threads()
    assert find_config.main(["--n_trials", "1", "--data_dir", str(data / "train"),
                             "--epochs", "5", *common]) == 0
    assert _writer_threads() <= before
    # every checkpoint the pruned trial wrote landed whole
    saved = sorted((tmp_path / "model_weights").glob("vanilla_*_epoch_*.pt"))
    assert [p.name[-6:] for p in saved] == ["001.pt", "002.pt", "003.pt", "004.pt"]
    for p in saved:
        assert ckpt.load_model(p)["epoch"] == int(p.name[-6:-3])
    assert find_config.main(["--n_trials", "1", "--data_dir", str(data / "train"),
                             "--epochs", "1", *common]) == 0
    assert find_config.main(["--n_trials", "1", "--data_dir", str(fed), "--epochs", "3",
                             "--federated", "--unencrypted_aggregation", *common]) == 0
    trials = json.loads(storage.read_text())["trials"][5:]
    assert [t["state"] for t in trials] == ["pruned", "complete", "complete"]
    pruned, local, federated = trials
    assert sorted(pruned["intermediate"], key=int) == ["1", "2", "3", "4", "5"]
    assert pruned["value"] == pruned["intermediate"]["5"] < 100.0
    assert list(local["intermediate"]) == ["1"]
    assert local["value"] == local["intermediate"]["1"]
    reps = federated["params"]["repetitions_dataset"]
    steps = [str(e * reps) for e in range(1, 3 // reps + 1)]
    assert list(federated["intermediate"]) == steps
    assert len(list((tmp_path / "model_weights").glob("final_federated_*.pt"))) == 1
    assert "best trial" in capsys.readouterr().out


class _PruneAt:
    """A stub trial that prunes at ``step``."""

    def __init__(self, step):
        self.step, self.reports = step, []

    def report(self, value, step):
        self.reports.append((step, value))

    def should_prune(self):
        return self.reports[-1][0] >= self.step


def _slow_writes(monkeypatch, seconds=0.3):
    save_tree = ckpt.save_tree

    def slow(path, tree):
        import time

        time.sleep(seconds)
        save_tree(path, tree)

    monkeypatch.setattr(ckpt, "save_tree", slow)


def test_pruned_federated_run_leaves_no_write_in_flight(tmp_path, monkeypatch):
    """The federated loop raises ``TrialPruned`` at the trial's word (the
    CLI's test prunes the local loop), and only after the write of the
    epoch before it has landed: the writer sleeps before each write, and
    the file is whole when the error arrives."""
    data = _fed_fixture(tmp_path / "d")
    monkeypatch.chdir(tmp_path)
    _slow_writes(monkeypatch)
    args = Arguments(model="simpleconv", pretrained=False, train_resolution=28,
                     inference_resolution=28, batch_size=12, epochs=3, test_interval=1,
                     data_dir=str(data), train_federated=True,
                     unencrypted_aggregation=True, repetitions_dataset=1,
                     sync_every_n_batch=2, save_file="")
    trial = _PruneAt(2)
    before = _writer_threads()
    with pytest.raises(TrialPruned):
        loop.main(args, verbose=False, device="cpu", weights_dir=str(tmp_path / "w"),
                  optuna_trial=trial)
    assert [s for s, _ in trial.reports] == [1, 2]
    assert _writer_threads() <= before
    (first,) = sorted((tmp_path / "w").glob("*_epoch_*.pt"))
    assert first.name.endswith("_epoch_001.pt")
    assert ckpt.load_model(first)["epoch"] == 1


def test_background_writer_writes_the_synchronous_files(tmp_path):
    """The writer's file, the synchronous save's and the save as it was
    before the writer (host copies in the caller) are the same bytes."""
    args = Arguments(model="simpleconv", pretrained=False, train_resolution=28,
                     inference_resolution=28, optimizer="Adam")
    torch.manual_seed(0)
    model = create_model(args, num_classes=3, device="cpu")
    raw = create_model(args, num_classes=3, device="cpu")
    opt = make_optimizer(args, model)
    with torch.no_grad():
        for m in opt.mu + opt.nu:
            m.normal_()
    opt.step = 3
    ms = (np.array([0.4]), np.array([0.2]))
    # the save as it was before the writer: host copies in the caller
    params, state = to_jax_tree(model)
    ckpt.save_tree(tmp_path / "before.pt", {
        "epoch": 2, "args": args.to_json(), "val_mean_std": ms,
        "model_state_dict": {"params": params, "state": state},
        "optim_state_dict": opt.state_to_jax(), "raw_params": to_jax_tree(raw)[0]})
    kw = dict(epoch=2, model=model, args=args, val_mean_std=ms, raw_model=raw)
    ckpt.save_model(tmp_path / "sync.pt", opt_state=opt.state_to_jax(), **kw)
    with ckpt.BackgroundWriter() as writer:
        writer.save_model(tmp_path / "bg.pt", opt_state=opt.state_to_jax(on_device=True), **kw)
        # the next steps' in-place updates reach nothing the writer holds
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
            for m in opt.mu:
                m.zero_()
    sync = (tmp_path / "sync.pt").read_bytes()
    assert (tmp_path / "bg.pt").read_bytes() == sync
    assert (tmp_path / "before.pt").read_bytes() == sync


def test_background_writer_raises_a_failed_write(tmp_path):
    args = Arguments(model="simpleconv", pretrained=False, train_resolution=28,
                     inference_resolution=28)
    model = create_model(args, num_classes=3, device="cpu")
    (tmp_path / "blocked").write_text("a file where the writer needs a folder")
    with pytest.raises(OSError):
        with ckpt.BackgroundWriter() as writer:
            writer.save_model(tmp_path / "blocked" / "x.pt", epoch=1, model=model, args=args,
                              val_mean_std=(np.zeros(1), np.ones(1)))
