"""The port's training slice against the JAX package.

Batch norm in train mode, the losses, mixup, the optimizers and their
checkpointed state, the LR schedule, one train step, the data helpers,
the metrics (against scikit-learn, which the JAX package calls) and the
train CLI end to end, on the CPU. Inputs are made with numpy and handed
to both packages; float32 on both sides. Each test states its limit.
"""

import argparse
import warnings
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.data import ImageFolderDataset as JaxImageFolderDataset
from primia_tpu.data import calc_mean_std as jax_calc_mean_std
from primia_tpu.data import random_split as jax_random_split
from primia_tpu.nn import ModelDef
from primia_tpu.nn.core import PLAIN
from primia_tpu.nn.core import batch_norm as jax_batch_norm
from primia_tpu.nn.resnet import resnet_forward
from primia_tpu.ops.augment import normalize_only as jax_normalize_only
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu.train import losses as jax_losses
from primia_tpu.train import optim as jax_optim
from primia_tpu.train.lr import LearningRateScheduler as JaxScheduler
from primia_tpu.train.steps import TrainState
from primia_tpu.train.steps import build_train_step as jax_build_train_step
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.data import ImageFolderDataset, calc_mean_std, random_split
from primia_tpu_torch.nn import ResNet
from primia_tpu_torch.nn.core import Norm
from primia_tpu_torch.nn.jax_params import from_jax_tree, param_leaves, to_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train import losses, metrics
from primia_tpu_torch.train.lr import LearningRateScheduler
from primia_tpu_torch.train.optim import SGD, Adam
from primia_tpu_torch.train.steps import build_train_step

ROOT = Path(__file__).resolve().parent.parent
CANONICAL = ROOT / "configs" / "torch" / "pneumonia-resnet-pretrained.ini"
RES = 32
LAYERS = (1, 1, 1, 1)


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")


def _small_resnet(seed=0):
    torch.manual_seed(seed)
    return ResNet(LAYERS, num_classes=3, in_channels=3, input_size=RES)


# ------------------------------------------------------------ batch norm

def test_train_mode_batch_norm_matches_jax():
    """Output and running statistics within 1e-5; the count goes up by one."""
    rng = np.random.default_rng(0)
    x = (rng.normal(0.3, 2.0, (6, 8, 5, 7))).astype(np.float32)  # NHWC
    g = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    b = rng.normal(0, 0.2, 7).astype(np.float32)
    mean = rng.normal(0, 0.1, 7).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    y_ref, st = jax_batch_norm(PLAIN, jnp.asarray(x), {"gamma": g, "beta": b},
                               {"mean": mean, "var": var, "count": np.int64(4)}, train=True)
    norm = Norm(7)
    norm.load_state_dict({"weight": torch.from_numpy(g), "bias": torch.from_numpy(b),
                          "running_mean": torch.from_numpy(mean),
                          "running_var": torch.from_numpy(var),
                          "num_batches_tracked": torch.tensor(4)})
    y = norm.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref),
                               atol=1e-5)
    np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(st["mean"]), atol=1e-5)
    np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(st["var"]), atol=1e-5)
    assert int(norm.num_batches_tracked) == int(st["count"]) == 5


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_losses_match_jax(weighted, masked):
    """Hard and one-hot cross entropy, both reductions: 1e-6."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (6, 3)).astype(np.float32)
    labels = rng.integers(0, 3, 6).astype(np.int32)
    soft = rng.dirichlet(np.ones(3), 6).astype(np.float32)
    w = np.array([0.2, 0.5, 0.3], np.float32) if weighted else None
    m = np.array([1, 1, 0, 1, 0, 1], np.float32) if masked else None
    t = lambda a: None if a is None else torch.from_numpy(a)
    j = lambda a: None if a is None else jnp.asarray(a)
    got = losses.cross_entropy(t(logits), t(labels), t(w), t(m))
    ref = jax_losses.cross_entropy(j(logits), j(labels), j(w), j(m))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    for red in ("mean", "sum"):
        got = losses.cross_entropy_one_hot(t(logits), t(soft), t(w), red, t(m))
        ref = jax_losses.cross_entropy_one_hot(j(logits), j(soft), j(w), red, j(m))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    oh = losses.to_one_hot(t(labels), 3)
    np.testing.assert_array_equal(oh.numpy(), np.asarray(jax_losses.to_one_hot(j(labels), 3)))


def test_mixup_given_the_permutation_and_lambda_is_exact():
    rng = np.random.default_rng(2)
    x = rng.random((5, 3, 4, 4), dtype=np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 5)]
    key = jax.random.PRNGKey(7)
    ref_x, ref_y = jax_losses.mixup(key, jnp.asarray(x), jnp.asarray(y), lam=0.3, prob=1.0)
    perm = np.asarray(jax.random.permutation(jax.random.split(key, 3)[2], 5))
    got_x, got_y = losses.mixup_with(torch.from_numpy(x), torch.from_numpy(y),
                                     torch.tensor(0.3, dtype=torch.float32),
                                     torch.from_numpy(perm.copy()))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(ref_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(ref_y))


def test_mixup_draws_keep_the_batch():
    x = torch.rand((8, 3, 4, 4))
    y = losses.to_one_hot(torch.arange(8) % 3, 3)
    mx, my = losses.mixup(torch.Generator().manual_seed(0), x, y, prob=1.0)
    assert mx.shape == x.shape and torch.allclose(my.sum(1), torch.ones(8))
    same_x, same_y = losses.mixup(torch.Generator().manual_seed(0), x, y, prob=0.0)
    assert torch.equal(same_x, x) and torch.equal(same_y, y)


def test_class_weights_match_jax():
    labels = np.array([0, 0, 1, 2, 2, 2], np.int32)
    np.testing.assert_array_equal(losses.calc_class_weights(labels, 4),
                                  jax_losses.calc_class_weights(labels, 4))


# ------------------------------------------------------------ optimizers

def _grads(params_tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: rng.normal(0, 1e-2, a.shape).astype(np.float32), params_tree)


def _port_grads(opt, grads_tree):
    by_name = from_jax_tree(grads_tree, {})
    return [by_name[n] for n in opt.names]


def _assert_params_equal(model, params_tree, rtol=1e-6):
    got = jax.tree.leaves(to_jax_tree(model)[0])
    want = jax.tree.leaves(params_tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=1e-9)


@pytest.mark.parametrize("kind,wd", [("adam", 0.0), ("adam", 5e-4), ("sgd", 0.0),
                                     ("sgd", 5e-4), ("momentum", 5e-4)])
def test_optimizer_steps_match_jax(kind, wd):
    """Three steps on identical gradients: parameters within 1e-6 relative;
    the stored moments within 1e-6 of their largest value (the two
    packages round the moment updates in another order)."""
    model = _small_resnet()
    params = to_jax_tree(model)[0]
    if kind == "adam":
        opt, jopt = Adam(model, 0.5, 0.99, weight_decay=wd), jax_optim.adam(0.5, 0.99,
                                                                            weight_decay=wd)
    else:
        mom = 0.9 if kind == "momentum" else 0.0
        opt, jopt = SGD(model, mom, weight_decay=wd), jax_optim.sgd(mom, weight_decay=wd)
    jstate = jopt.init(params)
    for i, lr in enumerate((1e-3, 1e-3, 5e-4)):
        g = _grads(params, i)
        opt.update(_port_grads(opt, g), lr)
        params, jstate = jopt.update(g, jstate, params, lr)
    _assert_params_equal(model, params)
    if kind != "sgd":
        stored = opt.state_to_jax()
        assert int(stored.step) == int(jstate.step) == 3
        for a, b in zip(stored[1:], jstate[1:]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def test_adam_state_round_trips_through_both_checkpoints(tmp_path):
    """The port writes the JAX flat layout, which the JAX loader reads;
    a JAX AdamState resumes in the port: one more step agrees."""
    model = _small_resnet(1)
    params = to_jax_tree(model)[0]
    opt, jopt = Adam(model, 0.5, 0.99, weight_decay=5e-4), jax_optim.adam(0.5, 0.99,
                                                                         weight_decay=5e-4)
    jstate = jopt.init(params)
    for i in range(3):
        g = _grads(params, 10 + i)
        opt.update(_port_grads(opt, g), 1e-3)
        params, jstate = jopt.update(g, jstate, params, 1e-3)

    path = tmp_path / "port.pt"
    ckpt.save_model(path, epoch=3, model=model, args=Arguments.from_ini(CANONICAL),
                    val_mean_std=(np.zeros(3), np.ones(3)), opt_state=opt.state_to_jax())
    back = jax_ckpt.load_model(path)["optim_state_dict"]
    assert type(back).__name__ == "AdamState" and int(back.step) == 3
    assert back.mu.shape == (sum(int(np.prod(a.shape)) for a in jax.tree.leaves(params)),)
    nu = np.asarray(jstate.nu)
    np.testing.assert_allclose(back.nu, nu, rtol=1e-6, atol=1e-6 * np.abs(nu).max())

    jax_ckpt.save_tree(tmp_path / "jax_state.npz", {"o": jstate})
    resumed_model = _small_resnet(2)
    resumed_model.load_state_dict(from_jax_tree(params, to_jax_tree(model)[1]))
    resumed = Adam(resumed_model, 0.5, 0.99, weight_decay=5e-4)
    resumed.load_jax_state(ckpt.load_tree(tmp_path / "jax_state.npz")["o"])
    g = _grads(params, 20)
    resumed.update(_port_grads(resumed, g), 1e-3)
    params, _ = jopt.update(g, jstate, params, 1e-3)
    _assert_params_equal(resumed_model, params)


def test_param_leaves_follow_ravel_pytree_order():
    from jax.flatten_util import ravel_pytree

    model = _small_resnet()
    params = to_jax_tree(model)[0]
    flat, _ = ravel_pytree(params)
    named = dict(model.named_parameters())
    from primia_tpu_torch.nn.jax_params import flatten_jax

    got = flatten_jax({n: named[n].detach() for n, _ in param_leaves(model)},
                      param_leaves(model))
    np.testing.assert_array_equal(got.numpy(), np.asarray(flat))


# ------------------------------------------------------------- schedule

@pytest.mark.parametrize("plan,restarts", [("log_linear", 0), ("log_cosine", 0),
                                           ("log_linear", 2), ("log_cosine", 1)])
def test_lr_schedule_matches_jax(plan, restarts):
    ours = LearningRateScheduler(12, np.log10(1e-4), np.log10(1e-5), plan, restarts)
    ref = JaxScheduler(12, np.log10(1e-4), np.log10(1e-5), plan, restarts)
    for e in range(12):
        assert ours.get_lr(e) == pytest.approx(ref.get_lr(e), rel=1e-12)


# ------------------------------------------------------------- train step

def _step_args(cls):
    args = cls.from_ini(CANONICAL)
    args.train_resolution = args.inference_resolution = RES
    args.batch_size = 4
    args.rotation = args.scale = args.shear = args.translate = 0.0
    args.albu_prob = 0.0
    args.noise_prob = 0.0
    args.clahe = args.mixup = False
    return args


class _Recorder:
    """Stands in for the optimizer: keeps the gradients it is given."""

    def __init__(self, model):
        self.names = [n for n, _ in param_leaves(model)]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]

    def update(self, grads, lr):
        self.grads = dict(zip(self.names, grads))


def test_one_f32_train_step_matches_jax():
    """Augmentation and mixup off, the same params and batch: the loss
    within 1e-5 relative, every gradient leaf within 1e-4 of its max |g|,
    the BN running statistics within 1e-5."""
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (4, RES, RES, 3), dtype=np.uint8)
    labels = np.array([0, 1, 2, 1], np.int32)
    mask = np.ones(4, np.float32)
    mean, std = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.24, 0.23])
    model = _small_resnet(3)
    params, state = to_jax_tree(model)

    rec = _Recorder(model)
    step = build_train_step(model, rec, _step_args(Arguments), mean, std, device="cpu")
    loss = float(step(torch.Generator().manual_seed(0), imgs, labels, mask, 1e-4))

    fwd = partial(resnet_forward, layers=LAYERS, pooling="max", input_size=RES)
    md = ModelDef("resnet-18", None, fwd, RES, 3, 3, "max")
    jstep = jax_build_train_step(md, jax_optim.adam(0.5, 0.99), _step_args(JaxArguments),
                                 mean, std, donate=False)
    opt_state = jax_optim.adam(0.5, 0.99).init(params)
    ts, ref_loss = jstep(TrainState(params, state, opt_state), jax.random.PRNGKey(0),
                         jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask), 1e-4)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)

    x = jax_normalize_only(jnp.asarray(imgs), mean, std, 3)

    def loss_fn(p):
        logits, _ = fwd(p, state, x, train=True)
        return jax_losses.cross_entropy(logits, jnp.asarray(labels), sample_mask=mask)

    ref_grads = from_jax_tree(jax.grad(loss_fn)(params), {})
    for name, g in rec.grads.items():
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)

    got_state = to_jax_tree(model)[1]
    for a, b in zip(jax.tree.leaves(got_state), jax.tree.leaves(ts.model_state)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


# ------------------------------------------------------------------ data

def test_calc_mean_std_and_random_split_match_jax(fixture_dir):
    imgs = np.random.default_rng(4).integers(0, 256, (7, 9, 9, 3), dtype=np.uint8)
    for a, b in zip(calc_mean_std(imgs), jax_calc_mean_std(imgs)):
        np.testing.assert_array_equal(a, b)
    ds = ImageFolderDataset(fixture_dir / "train")
    parts = random_split(ds, [9, 3], seed=5)
    ref = jax_random_split(JaxImageFolderDataset(fixture_dir / "train"), [9, 3], seed=5)
    for p, r in zip(parts, ref):
        np.testing.assert_array_equal(p.indices, r.indices)
        assert p.paths == r.paths and np.array_equal(p.labels, r.labels)
    with pytest.raises(ValueError):
        random_split(ds, [5, 5])


def test_batch_loader_shuffles_drops_and_gathers_tensors():
    """Shuffled with the seed as the JAX loader; ``drop_last``; a tensor
    dataset is gathered and padded as a tensor; ``device_prefetch`` hands
    the batches over in order."""
    from primia_tpu.data import BatchLoader as JaxBatchLoader
    from primia_tpu_torch.data import BatchLoader, device_prefetch, to_device_resident

    imgs = np.arange(7 * 2 * 2 * 1, dtype=np.uint8).reshape(7, 2, 2, 1)
    labels = np.arange(7, dtype=np.int32)
    ours = list(BatchLoader(imgs, labels, 3, seed=4))
    ref = list(JaxBatchLoader(imgs, labels, 3, seed=4))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.mask, b.mask)
    assert len(BatchLoader(imgs, labels, 3, drop_last=True)) == 2
    assert to_device_resident(imgs, "cpu") is imgs
    on_t = list(BatchLoader(torch.from_numpy(imgs), labels, 3, seed=4))
    for a, b in zip(on_t, ours):
        assert isinstance(a.images, torch.Tensor)
        np.testing.assert_array_equal(a.images.numpy(), b.images)
    fetched = list(device_prefetch(ours, "cpu", depth=2))
    assert len(fetched) == len(ours)
    for a, b in zip(fetched, ours):
        np.testing.assert_array_equal(a.images.numpy(), b.images)
        np.testing.assert_array_equal(a.labels.numpy(), b.labels)


# --------------------------------------------------------------- metrics

@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_scikit_learn(seed):
    """Numpy-only metrics against scikit-learn on random splits, one with
    an absent class and one where a class is never predicted: report,
    confusion matrix and MCC equal, ROC-AUC within 1e-12."""
    import sklearn.metrics as mt

    rng = np.random.default_rng(seed)
    n = 40
    targets = rng.integers(0, 2 if seed == 1 else 3, n)
    preds = rng.integers(0, 3, n) if seed != 2 else np.minimum(targets, 1)
    logits = rng.normal(size=(n, 3)).astype(np.float32)
    if seed == 3:
        logits = np.round(logits, 1)  # tied scores
    got = metrics.evaluate_predictions(targets, preds, logits, num_classes=3)
    labels = np.arange(3)
    np.testing.assert_array_equal(got["conf_matrix"],
                                  mt.confusion_matrix(targets, preds, labels=labels))
    assert got["report"] == mt.classification_report(targets, preds, labels=labels,
                                                     output_dict=True, zero_division=0)
    assert got["matthews_coeff"] == mt.matthews_corrcoef(targets, preds)
    if seed == 1:  # sklearn refuses a ROC-AUC with a class absent; both give 0
        with pytest.raises(ValueError):
            mt.roc_auc_score(targets, metrics.score_probabilities(logits), multi_class="ovo")
        assert got["roc_auc"] == 0.0
    else:
        ref = mt.roc_auc_score(targets, metrics.score_probabilities(logits), multi_class="ovo")
        assert 0.0 < ref and abs(got["roc_auc"] - ref) <= 1e-12


# ------------------------------------------------------------------- CLI

def _tiny_ini(tmp_path):
    text = CANONICAL.read_text()
    for old, new in (("batch_size = 200", "batch_size = 4"),
                     ("train_resolution = 224", f"train_resolution = {RES}"),
                     ("epochs = 40", "epochs = 1")):
        assert old in text
        text = text.replace(old, new)
    ini = tmp_path / "tiny.ini"
    ini.write_text(text)
    return ini


def test_train_cli_end_to_end_and_both_evaluates_agree(tmp_path, fixture_dir, monkeypatch):
    """The canonical recipe at 32 px, 1 epoch on the fixture, on the CPU:
    a ``final_*.pt`` that the JAX and the port's evaluate CLIs score to
    the same stats table."""
    from primia_tpu.cli.evaluate import main as jax_evaluate
    from primia_tpu_torch.cli.evaluate import main as port_evaluate
    from primia_tpu_torch.cli.train import main as port_train

    ini = _tiny_ini(tmp_path)
    monkeypatch.chdir(tmp_path)
    best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                       "--device", "cpu"])
    assert np.isfinite(best)
    finals = sorted((tmp_path / "model_weights").glob("final_*.pt"))
    assert len(finals) == 1
    assert not list((tmp_path / "model_weights").glob("*_epoch_*.pt"))
    assert (tmp_path / "model_weights" / "completed_trainings.csv").is_file()
    state = jax_ckpt.load_model(finals[0])
    assert state["epoch"] == 1 and int(state["optim_state_dict"].step) == 3

    argv = ["--data_dir", str(fixture_dir / "test"), "--model_weights", str(finals[0])]
    with pytest.warns(UserWarning, match="pretrained"):
        ref = jax_evaluate(argv)
    got = port_evaluate(argv + ["--device", "cpu"])
    np.testing.assert_array_equal(got["conf_matrix"], ref["conf_matrix"])
    assert got["report"] == ref["report"]
    assert got["matthews_coeff"] == ref["matthews_coeff"]
    assert got["roc_auc"] == pytest.approx(ref["roc_auc"], abs=1e-6)


def test_train_cli_resumes_model_and_optimizer(tmp_path, fixture_dir, monkeypatch):
    """A second run with ``--resume_checkpoint`` and ``epochs = 2`` trains
    epoch 2 only, from the stored weights and Adam state."""
    from primia_tpu_torch.cli.train import main as port_train

    ini = _tiny_ini(tmp_path)
    monkeypatch.chdir(tmp_path)
    argv = ["--data_dir", str(fixture_dir / "train"), "--device", "cpu"]
    port_train(["--config", str(ini)] + argv)
    first = sorted((tmp_path / "model_weights").glob("final_*.pt"))[0]
    first.rename(tmp_path / "first.pt")
    ini.write_text(ini.read_text().replace("epochs = 1", "epochs = 2"))
    port_train(["--config", str(ini), "--resume_checkpoint", str(tmp_path / "first.pt")] + argv)
    second = jax_ckpt.load_model(sorted((tmp_path / "model_weights").glob("final_*.pt"))[0])
    assert second["epoch"] == 2 and int(second["optim_state_dict"].step) == 6


def test_train_cli_defaults_to_cuda_and_ports_only_the_local_path(tmp_path, fixture_dir,
                                                                   monkeypatch):
    from primia_tpu_torch.cli import train
    from primia_tpu_torch.train import loop

    assert train.build_parser().parse_args(["--config", "x"]).device == "cuda"
    ini = _tiny_ini(tmp_path)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--config", str(ini), "--data_dir", str(fixture_dir / "train")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(argv)
    with pytest.raises(NotImplementedError, match="slice 4"):
        train.main(argv + ["--train_federated", "--device", "cpu"])
    args = Arguments.from_ini(ini, cmd_args=argparse.Namespace(data_dir="d"))
    args.differentially_private = True
    with pytest.raises(NotImplementedError, match="slice 5"):
        loop.main(args, device="cpu")


def test_run_registry_appends_rows(tmp_path):
    args = Arguments.from_ini(CANONICAL)
    args.save_file = str(tmp_path / "runs.csv")
    ckpt.save_config_results(args, 12.5, "t0")
    ckpt.save_config_results(args, 30.0, "t1", table="x")
    import csv

    with open(args.save_file, newline="") as f:
        rows = list(csv.DictReader(f))
    assert [r["best_validation_score"] for r in rows] == ["12.5", "30.0"]
    assert rows[0]["model"] == "resnet-18" and rows[1]["stats_table"] == "x"


def test_monitor_writes_jsonl_and_html(tmp_path):
    from primia_tpu_torch.train.monitor import Monitor, NullMonitor

    mon = Monitor("exp", directory=str(tmp_path))
    mon.add_scalar("train_loss", 1, 0.5)
    assert mon.jsonl.read_text().count("\n") == 1 and "<svg" in mon.html.read_text()
    NullMonitor().add_scalar("train_loss", 1, 0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        Monitor("exp2", directory=str(tmp_path), render_html=False).add_scalar("lr", 1, 1e-4)
