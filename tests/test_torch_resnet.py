"""ResNet-18 of the PyTorch port against the JAX package's forward.

The same JAX parameter trees (with batch-norm statistics drawn by numpy)
go into both sides; the port loads them through ``from_jax_tree``.
Float32 throughout. Limit: atol = rtol = 1e-4 on the logits (the two
convolution backends sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn.resnet import resnet18_forward, resnet18_init
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import create_model, resnet18
from primia_tpu_torch.nn.core import batch_norm, bn_fold, group_norm
from primia_tpu_torch.nn.jax_params import from_jax_tree, to_jax_tree

RES = 64


def _jax_tree(seed: int, in_channels: int = 3):
    params, state = jax.device_get(
        resnet18_init(jax.random.PRNGKey(seed), num_classes=3, in_channels=in_channels))
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf == "mean":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "beta":
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        return np.asarray(a)

    params = jax.tree_util.tree_map_with_path(draw, params)
    state = jax.tree_util.tree_map_with_path(draw, state)
    return params, state


def _port_logits(model, x_nhwc):
    with torch.inference_mode():
        x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
        return model(x.contiguous(memory_format=torch.channels_last)).numpy()


@pytest.mark.parametrize("pooling,swap_pool_relu,norm", [
    ("max", False, "batch"),
    ("avg", False, "batch"),
    ("max", True, "batch"),
    ("max", False, "group"),
])
def test_eval_logits_match_jax(pooling, swap_pool_relu, norm):
    params, state = _jax_tree(0)
    x = np.random.default_rng(1).random((2, RES, RES, 3)).astype(np.float32)
    ref, _ = resnet18_forward(params, state, jnp.asarray(x), pooling=pooling,
                              input_size=RES, swap_pool_relu=swap_pool_relu, norm=norm)
    model = resnet18(num_classes=3, in_channels=3, pooling=pooling, input_size=RES,
                     norm=norm, swap_pool_relu=swap_pool_relu)
    model.load_state_dict(from_jax_tree(params, state))
    model = model.to(memory_format=torch.channels_last).eval()
    got = _port_logits(model, x)
    assert got.dtype == np.float32 and got.shape == (2, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_jax_tree_round_trip_is_exact():
    params, state = _jax_tree(2, in_channels=1)
    model = resnet18(num_classes=3, in_channels=1, input_size=RES)
    model.load_state_dict(from_jax_tree(params, state))
    p2, s2 = to_jax_tree(model)
    for a, b in [(params, p2), (state, s2)]:
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.asarray(x).dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x), y)


def test_port_weights_run_in_jax():
    """A model made by the port, exported with ``to_jax_tree``, gives the
    same logits in the JAX forward."""
    torch.manual_seed(0)
    model = resnet18(num_classes=3, in_channels=3, input_size=RES).eval()
    params, state = to_jax_tree(model)
    x = np.random.default_rng(3).random((2, RES, RES, 3)).astype(np.float32)
    ref, _ = resnet18_forward(params, state, jnp.asarray(x), input_size=RES)
    got = _port_logits(model.to(memory_format=torch.channels_last), x)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_batch_norm_is_the_folded_affine():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 5, generator=g)
    gamma, beta, mean = (torch.randn(8, generator=g) for _ in range(3))
    var = torch.rand(8, generator=g) + 0.5
    f = bn_fold(gamma, beta, mean, var)
    want = x * f["scale"].reshape(1, -1, 1, 1) + f["offset"].reshape(1, -1, 1, 1)
    torch.testing.assert_close(batch_norm(x, gamma, beta, mean, var), want, rtol=0, atol=0)
    ref = torch.nn.functional.batch_norm(x, mean, var, gamma, beta, training=False)
    torch.testing.assert_close(want, ref, rtol=1e-5, atol=1e-5)


def test_group_norm_matches_torch_and_checks_groups():
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 6, 6, generator=g)
    w, b = torch.randn(64, generator=g), torch.randn(64, generator=g)
    ref = torch.nn.functional.group_norm(x, 32, w, b, eps=1e-5)
    torch.testing.assert_close(group_norm(x, w, b, groups=32), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        group_norm(torch.randn(1, 48, 2, 2), torch.ones(48), torch.zeros(48), groups=32)


def test_create_model_follows_the_config():
    args = Arguments(model="resnet-18", pretrained=True, inference_resolution=RES,
                     pooling_type="avg")
    model = create_model(args, num_classes=3, device="cpu")
    assert not model.training
    assert model.conv1.weight.shape == (64, 3, 7, 7)
    assert model.pooling == "avg" and model.input_size == RES
    assert model.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    gray = create_model(Arguments(pretrained=False), num_classes=3, device="cpu")
    assert gray.conv1.weight.shape == (64, 1, 7, 7)
    jargs = JaxArguments(model="resnet-18", pretrained=True, inference_resolution=RES)
    assert jargs.to_dict() == Arguments(model="resnet-18", pretrained=True,
                                        inference_resolution=RES).to_dict()


@pytest.mark.parametrize("name", ["vgg16", "simpleconv"])
def test_models_not_yet_ported_say_so(name, tmp_path, monkeypatch):
    """Both families build (their parity with the JAX package is
    ``tests/test_torch_models.py``); what the port still lacks for them says
    so: VGG-16's ImageNet import warns with the JAX package's words and
    keeps the init; SimpleConv refuses resolutions it has no variant for,
    and MNIST above 28 px names the missing port of ``native.py``."""
    from primia_tpu_torch.data.mnist import resize_to

    model = create_model(Arguments(model=name, inference_resolution=RES, train_resolution=28),
                         num_classes=3, device="cpu")
    assert (model.in_channels, model.num_classes) == (1, 3) and not model.training
    if name == "vgg16":
        weights = tmp_path / "vgg16-imagenet.pt"
        torch.save({}, weights)
        monkeypatch.setenv("PRIMIA_PRETRAINED", str(weights))
        with pytest.warns(UserWarning, match="pretrained import not implemented for vgg16"):
            model = create_model(Arguments(model=name, pretrained=True,
                                           inference_resolution=RES), num_classes=3, device="cpu")
        assert model.in_channels == 3
        with pytest.raises(ValueError, match="group"):
            create_model(Arguments(model=name, normalization="group"), device="cpu")
    else:
        with pytest.raises(ValueError, match="28/224/512"):
            create_model(Arguments(model=name, train_resolution=RES), device="cpu")
        with pytest.raises(NotImplementedError, match="native.py"):
            resize_to(np.zeros((1, 28, 28, 1), np.uint8), 224)
