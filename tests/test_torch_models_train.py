"""One train step of VGG-16 and SimpleConv, the port against the JAX
package, the opt-in kernel switches on their new shapes, and the train
CLI on both families (SimpleConv@28 through ``--data_dir mnist``).

The same parameters (JAX's init with biases drawn by numpy, carried by
``nn/jax_params.py``) and the same batch, augmentation and mixup off,
float32: the loss within 1e-5 relative, the classifier's gradients within
1e-4 of their max |g|. Under the switches (bfloat16 compute) the step
counts the kernels' plain-version calls.
"""

import os
from contextlib import nullcontext
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.ops.augment import normalize_only as jax_normalize_only
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu.train import losses as jax_losses
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.data.mnist import write_idx
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, param_leaves
from primia_tpu_torch.ops import cuda_bn, cuda_wgrad
from primia_tpu_torch.train.steps import build_train_step

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = ROOT / "configs" / "torch"
INIS = {"vgg16": CONFIGS / "pneumonia-vgg.ini", "simpleconv": CONFIGS / "pneumonia-conv.ini"}
SWITCHES = ("PRIMIA_PALLAS_WGRAD", "PRIMIA_PALLAS_BN", "PRIMIA_PALLAS_AUGMENT")
BN_PLAIN = ("channel_sums_plain", "bn_finalize_plain", "bn_apply_plain",
            "grad_channel_sums_plain", "bn_grad_finalize_plain", "bn_dx_plain")
# (model, resolution); VGG-16 takes the INI's 3 channels, SimpleConv 1
CASES = {"vgg32": ("vgg16", 32), "conv28": ("simpleconv", 28), "conv224": ("simpleconv", 224)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(cls, case, batch=2, dtype="float32"):
    model, res = CASES[case]
    args = cls.from_ini(INIS[model])
    args.train_resolution = args.inference_resolution = res
    args.batch_size = batch
    args.rotation = args.scale = args.shear = args.translate = 0.0
    args.albu_prob = args.noise_prob = 0.0
    args.clahe = args.mixup = args.elastic = False
    args.compute_dtype = dtype
    return args


class _Recorder:
    """Stands in for the optimizer: keeps the gradients it is given."""

    def __init__(self, model):
        self.names = [n for n, _ in param_leaves(model)]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]

    def update(self, grads, lr):
        self.grads = dict(zip(self.names, grads))


def _jax_model(case, seed=0):
    """JAX's ModelDef and (params, state), the conv biases and the BN
    statistics drawn by numpy."""
    args = _args(JaxArguments, case)
    with pytest.warns(UserWarning, match="pretrained") if args.pretrained else nullcontext():
        md = jax_create_model(args, num_classes=3)
    params, state = jax.device_get(jax.jit(md.init)(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf in ("b", "mean"):
            return rng.normal(0.0, 0.05, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return np.asarray(a)

    return md, jax.tree_util.tree_map_with_path(draw, params), \
        jax.tree_util.tree_map_with_path(draw, state)


def _port_model(case, params, state, dtype="float32"):
    args = _args(Arguments, case, dtype=dtype)
    with pytest.warns(UserWarning, match="pretrained") if args.pretrained else nullcontext():
        model = create_model(args, num_classes=3, device="cpu")
    model.load_state_dict(from_jax_tree(params, state))
    return model, args


def _batch(case, batch=2):
    model, res = CASES[case]
    ch = 3 if model == "vgg16" else 1
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (batch, res, res, ch), dtype=np.uint8)
    labels = np.array([2, 0, 1, 1][:batch], np.int32)
    mean, std = np.full(ch, 0.45), np.full(ch, 0.23)
    return imgs, labels, np.ones(batch, np.float32), mean, std


@pytest.mark.parametrize("case", list(CASES))
def test_one_f32_train_step_matches_jax(case):
    md, params, state = _jax_model(case)
    model, args = _port_model(case, params, state)
    imgs, labels, mask, mean, std = _batch(case)
    rec = _Recorder(model)
    step = build_train_step(model, rec, args, mean, std, device="cpu")
    loss = float(step(torch.Generator().manual_seed(0), imgs, labels, mask, 1e-4))

    x = jax_normalize_only(jnp.asarray(imgs), mean, std, md.in_channels)

    def loss_fn(p):
        logits, _ = md.forward(p, state, x, train=True)
        return jax_losses.cross_entropy(logits, jnp.asarray(labels), sample_mask=mask)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-5)
    ref_grads = from_jax_tree(jax.device_get(ref_grads), {})
    names = [n for n in rec.grads if n.startswith("classifier.")]
    assert len(names) == 6
    for name in names:
        ref = ref_grads[name].numpy()
        np.testing.assert_allclose(rec.grads[name].numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max(), err_msg=name)


def _counted_step(case, on, plain_names, module, batch=2):
    """One bfloat16 port step with the switches ``on``: (loss, calls of
    each plain version named)."""
    _, params, state = _jax_model(case)
    model, args = _port_model(case, params, state, dtype="bfloat16")
    imgs, labels, mask, mean, std = _batch(case, batch)
    step = build_train_step(model, _Recorder(model), args, mean, std, device="cpu")
    calls = dict.fromkeys(plain_names, 0)

    def counted(name):
        fn = getattr(module, name)

        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    env = {k: ("1" if k in on else "") for k in SWITCHES}
    patches = [mock.patch.object(module, n, counted(n)) for n in plain_names]
    with mock.patch.dict(os.environ, env):
        for p in patches:
            p.start()
        try:
            loss = float(step(torch.Generator().manual_seed(0), imgs, labels, mask, 1e-4))
        finally:
            for p in patches:
                p.stop()
    return loss, calls


def test_vgg_step_under_the_wgrad_switch_runs_k7_where_the_jax_package_does():
    """VGG@32, batch 2, bfloat16: the ten convs with 128 or more channels in
    and out (``features.3`` to ``features.12``) take ``conv3x3_s1p1``, and
    of those the four with at most 256 (``features.3`` to ``features.6``)
    take K7 for their weight gradient, as the JAX package's
    ``pallas_wgrad.py:_bwd`` (the C = 512 stage keeps the library's): four
    plain-version calls a step, none on the default step; the losses
    within 1e-2 relative."""
    from primia_tpu_torch.nn import core

    routed = []
    conv = core.conv3x3_s1p1
    with mock.patch.object(core, "conv3x3_s1p1",
                           lambda x, w: routed.append(tuple(w.shape[:2])) or conv(x, w)):
        loss_s, calls_s = _counted_step("vgg32", SWITCHES[:1], ("conv3x3_wgrad_plain",),
                                        cuda_wgrad)
    assert len(routed) == 10 and sum(max(s) <= 256 for s in routed) == 4
    loss_d, calls_d = _counted_step("vgg32", (), ("conv3x3_wgrad_plain",), cuda_wgrad)
    assert calls_s == {"conv3x3_wgrad_plain": 4} and calls_d == {"conv3x3_wgrad_plain": 0}
    assert np.isfinite(loss_s) and abs(loss_s - loss_d) <= 1e-2 * abs(loss_d)


def test_simpleconv_step_under_the_bn_switch_runs_each_kind_three_times():
    """SimpleConv@224, batch 2, bfloat16: its three batch norms (C = 8, 32
    and 128 on 111², 54² and 12² maps) each run the switched BN's six
    launches' plain versions once a step."""
    loss_s, calls = _counted_step("conv224", SWITCHES[1:2], BN_PLAIN, cuda_bn)
    assert calls == dict.fromkeys(BN_PLAIN, 3)
    loss_d, calls_d = _counted_step("conv224", (), BN_PLAIN, cuda_bn)
    assert calls_d == dict.fromkeys(BN_PLAIN, 0)
    assert np.isfinite(loss_s) and abs(loss_s - loss_d) <= 1e-2 * abs(loss_d)


def _tiny_ini(tmp_path, src, cuts):
    text = src.read_text()
    for old, new in cuts:
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / f"tiny-{src.stem}.ini"
    ini.write_text(text)
    return ini


def test_train_cli_trains_vgg(tmp_path, fixture_dir, monkeypatch):
    """``pneumonia-vgg.ini`` at 32 px, one epoch of one step (batch 12, the
    fixture's 12 images): a final checkpoint of the VGG-16 tree that the
    JAX package loads."""
    from primia_tpu_torch.cli.train import main as port_train

    ini = _tiny_ini(tmp_path, INIS["vgg16"], (
        ("batch_size = 64", "batch_size = 12"), ("train_resolution = 224", "train_resolution = 32"),
        ("epochs = 40", "epochs = 1")))
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="pretrained"):
        best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                           "--device", "cpu"])
    assert np.isfinite(best)
    final = sorted((tmp_path / "model_weights").glob("final_*.pt"))
    assert len(final) == 1
    state = jax_ckpt.load_model(final[0])
    params = state["model_state_dict"]["params"]
    assert len(params["features"]) == 13 and len(params["classifier"]) == 3
    assert params["features"][0]["w"].shape == (3, 3, 3, 64)
    assert int(state["optim_state_dict"].step) == 1


def write_mnist(root: Path, n_train: int, n_test: int, seed: int = 0) -> None:
    """A synthetic 10-class MNIST in IDX files: each digit class a bright
    square at its own place on a noisy background."""
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    for split, n in (("train", n_train), ("t10k", n_test)):
        labels = np.arange(n, dtype=np.uint8) % 10
        imgs = rng.integers(0, 60, (n, 28, 28), dtype=np.uint8)
        for i, d in enumerate(labels):
            r, c = 2 + 5 * (d // 5), 2 + 5 * (d % 5)
            imgs[i, r:r + 8, c:c + 8] = 255
        write_idx(root / f"{split}-images-idx3-ubyte", imgs)
        write_idx(root / f"{split}-labels-idx1-ubyte", labels)


def test_train_cli_trains_simpleconv_on_mnist(tmp_path, monkeypatch, capsys):
    """``mnist.ini`` (SimpleConv@28, 1 channel) through ``--data_dir mnist``
    on a synthetic IDX set under ``$MNIST_DIR``, batch 16, one epoch: 10
    classes in the stats table and a finite objective."""
    from primia_tpu_torch.cli.train import main as port_train

    write_mnist(tmp_path / "idx", 64, 30)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path / "idx"))
    ini = _tiny_ini(tmp_path, CONFIGS / "mnist.ini", (
        ("batch_size = 128", "batch_size = 16"), ("epochs = 10", "epochs = 1")))
    monkeypatch.chdir(tmp_path)
    best = port_train(["--config", str(ini), "--data_dir", "mnist", "--device", "cpu"])
    assert np.isfinite(best)
    out = capsys.readouterr().out
    assert "Train Epoch: 1" in out and all(f"│ {d} " in out for d in "0123456789")
    state = jax_ckpt.load_model(sorted((tmp_path / "model_weights").glob("final_*.pt"))[0])
    params = state["model_state_dict"]["params"]
    assert params["convs"][0]["w"].shape == (3, 3, 1, 8)
    assert params["classifier"][2]["w"].shape == (512, 10)
    assert int(state["optim_state_dict"].step) == 4
