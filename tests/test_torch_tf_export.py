"""The TF SavedModel bridge (``nn/tf_export.py``) against the port's eval
path and the JAX package's SavedModel (``tests/test_tf_export.py``'s
counterpart).

The port writes the eval forward in TF ops, where the JAX package stages
its jitted function out through jax2tf. One npz checkpoint, written by
the JAX package from its own initialisation, feeds both exporters; their
SavedModels and the port's eval step must agree within 1e-4, at a fixed
batch of 4 and a dynamic one (1 and 3).
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.nn.tf_export import (export_checkpoint, export_saved_model,
                                           load_saved_model, make_serving_fn, tf_available)

pytestmark = pytest.mark.skipif(not tf_available(),
                                reason="tensorflow not importable (the bridge is gated)")

# SimpleConv at its 28 px, ResNet-18 and VGG-16 at their full widths on the
# smallest image they take (five halvings: 32 px)
CASES = {"simpleconv": (28, 1), "resnet-18": (32, 3), "vgg16": (32, 3)}


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _checkpoint(tmp_path, name):
    """A JAX-written checkpoint of ``name`` at its case's size, with a
    non-trivial BN state; returns (path, args, mean, std, images)."""
    import jax

    from primia_tpu.config import Arguments as JaxArguments
    from primia_tpu.nn import create_model as jax_create_model
    from primia_tpu.train import checkpoint as jax_ckpt

    res, ch = CASES[name]
    args = JaxArguments(model=name, train_resolution=res, inference_resolution=res,
                        pooling_type="max", pretrained=ch == 3, num_classes=3)
    md = jax_create_model(args, num_classes=3)
    params, state = md.init(jax.random.PRNGKey(0))
    if name == "vgg16":  # its N(0, 0.01) classifier gives logits near 1e-4
        params["classifier"] = [{"w": np.asarray(c["w"]) * 10, "b": c["b"]}
                                for c in params["classifier"]]
    rng = np.random.default_rng(3)
    state = jax.tree.map(lambda a: np.asarray(a) if np.asarray(a).dtype.kind == "i" else
                         (np.asarray(a) + rng.uniform(0.1, 0.5, np.shape(a))).astype(
                             np.float32), state)
    mean = np.linspace(0.4, 0.5, ch)
    std = np.linspace(0.2, 0.25, ch)
    path = str(tmp_path / f"{name}.pt")
    jax_ckpt.save_model(path, epoch=1, params=params, model_state=state, opt_state=None,
                        args=args, val_mean_std=(mean, std))
    imgs = rng.integers(0, 256, (4, res, res, ch), dtype=np.uint8)
    return path, mean, std, imgs


def _port_model(path):
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.nn.jax_params import from_jax_tree
    from primia_tpu_torch.train import checkpoint as ckpt

    state = ckpt.load_model(path)
    model = create_model(state["args"], device="cpu")
    msd = state["model_state_dict"]
    model.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    return model, state["args"]


@pytest.mark.parametrize("name", list(CASES))
def test_savedmodel_matches_eval_step_and_jax(tmp_path, name):
    from primia_tpu.nn.tf_export import export_checkpoint as jax_export_checkpoint
    from primia_tpu_torch.train.steps import build_eval_step

    path, mean, std, imgs = _checkpoint(tmp_path, name)
    model, args = _port_model(path)
    labels, mask = np.zeros(4, np.int64), np.ones(4, np.float32)
    _, logits = build_eval_step(model, args, mean, std, device="cpu")(imgs, labels, mask)
    ref = logits.numpy()
    assert np.abs(ref).max() > 1e-3  # a head that says something

    fixed = load_saved_model(export_checkpoint(path, str(tmp_path / "port4"), batch_size=4))
    dynamic = load_saved_model(export_checkpoint(path, str(tmp_path / "port")))
    jax_dynamic = load_saved_model(jax_export_checkpoint(path, str(tmp_path / "jax")))
    out = fixed(imgs)
    assert out.shape == (4, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    for b in (1, 3):
        got = dynamic(imgs[:b])
        assert got.shape == (b, 3)
        np.testing.assert_allclose(got, ref[:b], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got, jax_dynamic(imgs[:b]), rtol=0, atol=1e-4)


def test_serving_fn_group_norm_and_direct_export(tmp_path):
    """A group-norm ResNet (the DP models' normalisation) with a live head,
    exported from the module: the eager TF function and the SavedModel
    against the eval step within 1e-4."""
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.steps import build_eval_step

    args = Arguments(model="resnet-18", train_resolution=32, inference_resolution=40,
                     normalization="group")
    torch.manual_seed(1)
    model = create_model(args, num_classes=3, device="cpu")
    model.input_size = 40
    with torch.no_grad():
        model.fc.weight.normal_(0, 0.1)
    mean, std = np.array([0.5]), np.array([0.25])
    imgs = np.random.default_rng(2).integers(0, 256, (3, 40, 40, 1), dtype=np.uint8)
    _, ref = build_eval_step(model, args, mean, std, device="cpu")(
        imgs, np.zeros(3, np.int64), np.ones(3, np.float32))
    eager = np.asarray(make_serving_fn(model, mean, std, args.train_resolution)(imgs))
    np.testing.assert_allclose(eager, ref.numpy(), rtol=0, atol=1e-4)
    run = load_saved_model(export_saved_model(model, mean, std, str(tmp_path / "gn"),
                                              train_resolution=32))
    np.testing.assert_allclose(run(imgs), ref.numpy(), rtol=0, atol=1e-4)
