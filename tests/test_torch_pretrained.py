"""``pretrained = yes`` in the port (``nn/torch_import.py``) against the
JAX package's ``nn/torch_import.py``.

A torchvision-named ResNet-18 state dict of random weights (running
statistics and ``num_batches_tracked`` included) is written to a
temporary file and found through ``$PRIMIA_PRETRAINED`` or
``model_weights/resnet-18-imagenet.pt``: no download. Both packages'
``create_model`` and train loops start from it, on the CPU in float32 at
32 px; with no file both warn and keep the He init. Each test states its
limit.
"""

import dataclasses
import types
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.nn.torch_import as jax_import
import primia_tpu.train.loop as jax_loop
import primia_tpu_torch.train.loop as port_loop
from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.nn.resnet import resnet18_forward
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import create_model, resnet18
from primia_tpu_torch.nn.jax_params import from_jax_tree
from primia_tpu_torch.nn.torch_import import try_load_pretrained

RES = 32


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torchvision_state_dict(num_classes: int, seed: int):
    """Random weights under torchvision's resnet18 keys: conv1, bn1,
    layerK.i.{conv,bn}{1,2}, layerK.0.downsample.{0,1} and fc."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, co, ci, k):
        sd[f"{name}.weight"] = torch.randn(co, ci, k, k, generator=g) * (2.0 / (k * k * co)) ** 0.5

    def bn(name, c):
        sd[f"{name}.weight"] = 1.0 + 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.bias"] = 0.1 * torch.randn(c, generator=g)
        sd[f"{name}.running_mean"] = torch.rand(c, generator=g) * 0.4 - 0.2
        sd[f"{name}.running_var"] = torch.rand(c, generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(42)

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for li, planes in enumerate((64, 128, 256, 512), 1):
        for bi in range(2):
            pre = f"layer{li}.{bi}"
            conv(f"{pre}.conv1", planes, cin, 3)
            bn(f"{pre}.bn1", planes)
            conv(f"{pre}.conv2", planes, planes, 3)
            bn(f"{pre}.bn2", planes)
            if cin != planes:
                conv(f"{pre}.downsample.0", planes, cin, 1)
                bn(f"{pre}.downsample.1", planes)
            cin = planes
    sd["fc.weight"] = 0.05 * torch.randn(num_classes, 512, generator=g)
    sd["fc.bias"] = 0.05 * torch.randn(num_classes, generator=g)
    return sd


def _torchvision_key(name: str) -> str:
    return name.replace(".down_conv.", ".downsample.0.").replace(".down_bn.", ".downsample.1.")


def _args(cls):
    return cls(model="resnet-18", pretrained=True, train_resolution=RES,
               inference_resolution=RES)


def _weights_file(tmp_path, monkeypatch, num_classes, where):
    """Saves the state dict where ``where`` says ("env":
    ``$PRIMIA_PRETRAINED``, "cwd": ``model_weights/`` of the working
    directory); returns it."""
    sd = _torchvision_state_dict(num_classes, 7)
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PRIMIA_PRETRAINED", raising=False)
    if where == "env":
        path = tmp_path / "elsewhere" / "weights.pt"
        monkeypatch.setenv("PRIMIA_PRETRAINED", str(path))
    else:
        path = tmp_path / "model_weights" / "resnet-18-imagenet.pt"
    path.parent.mkdir()
    torch.save(sd, path)
    return sd


def _logits(model, params, state, seed=3):
    """The port's and the JAX model's float32 eval logits of one batch."""
    x = np.random.default_rng(seed).standard_normal((2, RES, RES, 3)).astype(np.float32)
    ref, _ = resnet18_forward(params, state, jnp.asarray(x), pooling="max", input_size=RES)
    with torch.no_grad():
        got = model.float().eval()(torch.from_numpy(x).permute(0, 3, 1, 2)
                                   .contiguous(memory_format=torch.channels_last))
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("where", ["env", "cwd"])
def test_both_packages_start_from_the_file(tmp_path, monkeypatch, where):
    """Every tensor of the port's model equals the file's under its
    torchvision name (the 3-class fc included) and the JAX package's
    overlaid tree, bit for bit; the eval logits agree within 1e-4 of their
    largest |value| (float32 convs on the CPU, summed in other orders)."""
    sd = _weights_file(tmp_path, monkeypatch, 3, where)
    model = create_model(_args(Arguments), num_classes=3, device="cpu")
    md = jax_create_model(_args(JaxArguments), num_classes=3)
    params, state = md.init(jax.random.PRNGKey(0))
    ours = model.state_dict()
    jax_sd = from_jax_tree(params, state)
    assert set(ours) == set(jax_sd)
    for name, t in ours.items():
        torch.testing.assert_close(t, sd[_torchvision_key(name)], rtol=0, atol=0, msg=name)
        torch.testing.assert_close(t, jax_sd[name], rtol=0, atol=0, msg=name)
    got, ref = _logits(model, params, state)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_a_1000_class_head_leaves_the_fc_untouched(tmp_path, monkeypatch):
    """The file's 1000-class fc is not copied: the port's fc is the one
    the same seed gives without a file, and the backbone is the file's."""
    sd = _weights_file(tmp_path, monkeypatch, 1000, "env")
    torch.manual_seed(11)
    model = create_model(_args(Arguments), num_classes=3, device="cpu")
    torch.manual_seed(11)
    fresh = resnet18(num_classes=3, in_channels=3, input_size=RES)
    for name in ("fc.weight", "fc.bias"):
        torch.testing.assert_close(model.state_dict()[name], fresh.state_dict()[name],
                                   rtol=0, atol=0)
    torch.testing.assert_close(model.state_dict()["layer4.1.conv2.weight"],
                               sd["layer4.1.conv2.weight"], rtol=0, atol=0)
    params, _ = jax_create_model(_args(JaxArguments), num_classes=3).init(
        jax.random.PRNGKey(0))
    assert params["fc"]["w"].shape == (512, 3)


def test_both_warn_and_keep_he_init_without_a_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PRIMIA_PRETRAINED", raising=False)
    with pytest.warns(UserWarning, match="no local weights found for resnet-18"):
        jax_create_model(_args(JaxArguments), num_classes=3)
    with pytest.warns(UserWarning, match="no local weights found for resnet-18"):
        model = create_model(_args(Arguments), num_classes=3, device="cpu")
    assert float(model.bn1.running_var.min()) == 1.0  # the untouched init
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # pretrained = no: no warning
        create_model(Arguments(model="resnet-18", pretrained=False,
                               inference_resolution=RES), num_classes=3, device="cpu")


def test_both_warn_for_another_model(tmp_path, monkeypatch):
    """A file is found, but only ResNet-18 is imported."""
    _weights_file(tmp_path, monkeypatch, 3, "env")
    with pytest.warns(UserWarning, match="pretrained import not implemented for vgg16"):
        assert jax_import.try_load_pretrained(types.SimpleNamespace(name="vgg16"), None) is None
    with pytest.warns(UserWarning, match="pretrained import not implemented for vgg16"):
        assert try_load_pretrained("vgg16") is None


class _Started(Exception):
    pass


def test_both_train_loops_start_from_the_file(tmp_path, monkeypatch, fixture_dir):
    """Each package's ``train/loop.py:main`` on the canonical recipe at 32
    px, stopped where it makes its optimizer: the models it starts from
    agree as in the first test."""
    _weights_file(tmp_path, monkeypatch, 3, "env")
    ini = tmp_path / "tiny.ini"
    text = (Path(__file__).resolve().parent.parent / "configs" / "torch" / "pneumonia-resnet-pretrained.ini").read_text()
    assert "pretrained = yes" in text and "train_resolution = 224" in text
    ini.write_text(text.replace("train_resolution = 224", f"train_resolution = {RES}"))
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    seen = {}

    def port_optimizer(args, model):
        seen["port"] = model
        raise _Started

    class JaxOptimizer:
        def init(self, params):
            raise _Started

    def jax_optimizer(args):
        return JaxOptimizer()

    real_create = jax_loop.create_model

    def jax_create(*a, **kw):
        md = real_create(*a, **kw)

        def init(key):
            seen["jax"] = md.init(key)
            return seen["jax"]
        return dataclasses.replace(md, init=init)

    monkeypatch.setattr(port_loop, "make_optimizer", port_optimizer)
    monkeypatch.setattr(jax_loop, "make_optimizer", jax_optimizer)
    monkeypatch.setattr(jax_loop, "create_model", jax_create)
    for cls, loop, kw in ((Arguments, port_loop, {"device": "cpu"}), (JaxArguments, jax_loop, {})):
        args = cls.from_ini(ini)
        args.data_dir = str(fixture_dir / "train")
        with pytest.raises(_Started):
            loop.main(args, verbose=False, **kw)
    params, state = seen["jax"]
    ours, jax_sd = seen["port"].state_dict(), from_jax_tree(params, state)
    for name, t in ours.items():
        torch.testing.assert_close(t.cpu(), jax_sd[name], rtol=0, atol=0, msg=name)
    got, ref = _logits(seen["port"].cpu(), params, state)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
