"""VGG-16 and SimpleConv (28/224/512 px) of the PyTorch port against the
JAX package.

The same JAX parameter trees (biases, batch-norm statistics and the
classifier drawn by numpy, so that every leaf matters) go into both
sides; the port loads them through ``from_jax_tree``. Float32 throughout.
Limits: eval logits within 1e-5 of max |logit|; train-mode batch-norm
running statistics within 1e-5; trees, leaf paths, the secure aggregate
and parameter counts exactly; the evaluate CLIs' stats tables equal.
"""

from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.mpc import aggregation as jagg
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.nn.core import param_count
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc import aggregation as agg
from primia_tpu_torch.nn import SimpleConv, create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, jax_leaf_paths, to_jax_tree

TOL = 1e-5

# (model, resolution, channels, pooling, normalization, batch)
CASES = {
    "vgg_3ch_max": ("vgg16", 32, 3, "max", "batch", 2),
    "vgg_3ch_avg": ("vgg16", 32, 3, "avg", "batch", 2),
    "vgg_1ch_max": ("vgg16", 32, 1, "max", "batch", 2),
    "vgg_1ch_avg": ("vgg16", 32, 1, "avg", "batch", 2),
    "conv28": ("simpleconv", 28, 1, "max", "batch", 2),
    "conv224_batch": ("simpleconv", 224, 1, "max", "batch", 1),
    "conv224_group": ("simpleconv", 224, 1, "max", "group", 1),
    "conv512": ("simpleconv", 512, 1, "avg", "batch", 1),
}


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(cls, model, res, channels, pooling="max", norm="batch"):
    return cls(model=model, pretrained=channels == 3, train_resolution=res,
               inference_resolution=res, pooling_type=pooling, normalization=norm,
               clahe=False)


def _draw(params, state, seed):
    """The init's zero biases, unit BN statistics and small classifier
    replaced by numpy draws."""
    rng = np.random.default_rng(seed)

    def draw(path, a):
        leaf = path[-1].key
        if leaf in ("b", "beta", "mean"):
            return rng.normal(0.0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "w" and a.ndim == 2:
            return rng.normal(0.0, 1.0 / np.sqrt(a.shape[0]), a.shape).astype(np.float32)
        return np.asarray(a)

    return (jax.tree_util.tree_map_with_path(draw, params),
            jax.tree_util.tree_map_with_path(draw, state))


def _both(case, seed=0, draw=True):
    """(JAX ModelDef, params, state, the port's model loaded from them)."""
    model, res, ch, pooling, norm, _ = CASES[case]
    with pytest.warns(UserWarning, match="pretrained") if ch == 3 else nullcontext():
        md = jax_create_model(_args(JaxArguments, model, res, ch, pooling, norm), num_classes=3)
        port = create_model(_args(Arguments, model, res, ch, pooling, norm), num_classes=3,
                            device="cpu")
    params, state = jax.device_get(md.init(jax.random.PRNGKey(seed)))
    if draw:
        params, state = _draw(params, state, seed)
    port.load_state_dict(from_jax_tree(params, state))
    return md, params, state, port


def _port_logits(model, x_nhwc):
    with torch.inference_mode():
        x = torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)
        return model(x.contiguous(memory_format=torch.channels_last)).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_logits_match_jax(case):
    md, params, state, port = _both(case)
    _, res, ch, _, _, batch = CASES[case]
    assert (port.in_channels, port.num_classes, port.input_size) == (ch, 3, res)
    x = np.random.default_rng(1).normal(0, 1, (batch, res, res, ch)).astype(np.float32)
    ref = np.asarray(md.forward(params, state, jnp.asarray(x))[0])
    got = _port_logits(port, x)
    assert got.dtype == np.float32 and got.shape == (batch, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * np.abs(ref).max())


def test_train_mode_batch_norm_statistics_match_jax():
    """SimpleConv@224's three batch norms in train mode at batch 3 on
    full-range noise images: the running statistics after one forward."""
    md, params, state, port = _both("conv224_batch", seed=2)
    x = np.random.default_rng(3).uniform(-2, 2, (3, 224, 224, 1)).astype(np.float32)
    _, ref_state = md.forward(params, state, jnp.asarray(x), train=True)
    port.train()
    with torch.no_grad():
        port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    got = to_jax_tree(port)[1]
    assert jax.tree.structure(got) == jax.tree.structure(ref_state)
    for (path, a), b in zip(tree_flatten_with_path(got)[0], jax.tree.leaves(ref_state)):
        b = np.asarray(b)
        if path[-1].key == "count":
            assert int(a) == int(b) == 1
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL * max(np.abs(b).max(), 1.0),
                                       err_msg=keystr(path))


@pytest.mark.parametrize("case", ["vgg_3ch_max", "conv28", "conv224_batch", "conv512"])
def test_parameter_counts_equal_jax(case):
    _, params, _, port = _both(case, draw=False)
    assert sum(p.numel() for p in port.parameters()) == param_count(params)


@pytest.mark.parametrize("case", ["vgg_1ch_max", "conv28", "conv224_batch", "conv224_group",
                                  "conv512"])
def test_jax_tree_round_trip_is_exact_with_jax_paths(case):
    """``to_jax_tree`` of the loaded model gives back the JAX trees bit for
    bit, and ``jax_leaf_paths`` gives JAX's paths in JAX's order: string
    keys for SimpleConv's ``bns`` ("0", "1", "3"), list indices elsewhere."""
    _, params, state, port = _both(case)
    p2, s2 = to_jax_tree(port)
    for a, b in ((params, p2), (state, s2)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.asarray(x).dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x), y)
    flat = tree_flatten_with_path({"params": params, "state": state})[0]
    ours = jax_leaf_paths(port)
    assert [keystr(p) for p, _ in flat] == [agg._keystr(p) for p, _ in ours]
    assert [jagg._leaf_key(p) for p, _ in flat] == [agg._leaf_key(p) for p, _ in ours]
    sd = port.state_dict()
    assert {n for _, n in ours} == set(sd)
    for (_, leaf), (_, name) in zip(flat, ours):
        assert sd[name].numel() == np.asarray(leaf).size
    if case.startswith("conv224"):
        assert sorted(params["bns"]) == ["0", "1", "3"] and isinstance(port, SimpleConv)


def test_secure_aggregation_of_simpleconv_trees_is_bit_equal_to_jax():
    """Three nodes' SimpleConv@28 trees, aggregated leaf by leaf as the
    federated nodes do (``jax_leaf_paths`` -> ``secure_fedavg_leaf``),
    equal JAX's ``secure_fedavg`` of the stacked trees bit for bit."""
    trees, sds = [], []
    for node in range(3):
        _, params, state, port = _both("conv28", seed=10 + node)
        trees.append({"params": params, "state": state})
        sds.append(port.state_dict())
    weights = np.array([3, 3, 2], np.float64) / 8
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    ref = jax.tree.leaves(jax.jit(
        lambda t: jagg.secure_fedavg(jax.random.PRNGKey(42), t, weights))(stacked))
    paths = jax_leaf_paths(port)
    assert len(paths) == len(ref) == 18
    for (path, name), b in zip(paths, ref):
        leaf = torch.stack([sd[name] for sd in sds])
        got = agg.secure_fedavg_leaf((42, 777, 1), path, leaf, weights)
        # the port's modules hold OIHW / (out, in); the JAX leaves HWIO / (in, out)
        b = np.asarray(b)
        if got.dim() == 4:
            b = b.transpose(3, 2, 0, 1)
        elif got.dim() == 2:
            b = b.T
        assert got.dtype == torch.float32 and got.numpy().tobytes() == b.tobytes(), name


@pytest.mark.parametrize("case", ["vgg_3ch_max", "conv28"])
def test_jax_checkpoint_evaluates_to_the_same_stats_table(case, tmp_path, fixture_dir, capsys):
    """A JAX checkpoint (``save_tree`` under ``save_model``) of each family,
    through both packages' evaluate CLIs on the fixture's test folder."""
    from primia_tpu.cli.evaluate import main as jax_main
    from primia_tpu_torch.cli.evaluate import main

    model, res, ch, pooling, norm, _ = CASES[case]
    md, params, state, _ = _both(case)
    args = _args(JaxArguments, model, res, ch, pooling, norm)
    path = tmp_path / f"{case}.pt"
    mean_std = (np.full(ch, 0.45), np.full(ch, 0.22))
    jax_ckpt.save_model(path, epoch=2, params=params, model_state=state, opt_state=None,
                        args=args, val_mean_std=mean_std)
    argv = ["--data_dir", str(fixture_dir / "test"), "--model_weights", str(path)]
    with pytest.warns(UserWarning, match="pretrained") if ch == 3 else nullcontext():
        ref = jax_main(argv)
        ref_out = capsys.readouterr().out
        got = main(argv + ["--device", "cpu"])
    got_out = capsys.readouterr().out
    # each prints its arguments, then the stats table: the last table
    ref_table, got_table = (out[out.rindex("\u2552"):] for out in (ref_out, got_out))
    np.testing.assert_array_equal(got["conf_matrix"], ref["conf_matrix"])
    assert got["report"] == ref["report"] and got["matthews_coeff"] == ref["matthews_coeff"]
    assert got["roc_auc"] == pytest.approx(ref["roc_auc"], abs=1e-6)
    assert got_table == ref_table
