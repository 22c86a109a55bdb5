"""DP-SGD on SimpleConv, whose convs carry biases: the port's ghost-norm
step against its microbatched step and against the JAX package's ghost
step, and both conv DP recipes (``pneumonia-conv-dp.ini``, local, and
``pneumonia-conv-dp-federated.ini``) through the train CLI, on the CPU.

Both packages' augmentation is replaced by one that returns the same
explicit views (as ``tests/test_torch_dp.py`` does); sigma = 0; float32.
Each test states its limit.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.train.dp as jdp
import primia_tpu_torch.train.dp as dp
from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.train.steps import TrainState
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree, param_leaves, to_jax_tree

ROOT = Path(__file__).resolve().parent.parent
DP_INI = ROOT / "configs" / "torch" / "pneumonia-conv-dp.ini"
DP_FED_INI = ROOT / "configs" / "torch" / "pneumonia-conv-dp-federated.ini"
RES, B = 28, 6
MEAN, STD = np.array([0.5]), np.array([0.25])
KEY = jax.random.PRNGKey(3)


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    for k in ("PRIMIA_DP_GHOST", "PRIMIA_DP_SECURE_NOISE", "PRIMIA_PALLAS_WGRAD"):
        monkeypatch.delenv(k, raising=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(cls):
    """The conv DP INI at 28 px (SimpleConv@28: six biased convs, no
    norm), batch 6, K = 1, clip 1e-3 (below every example's norm), sigma
    0, augmentation off (both packages get explicit views)."""
    args = cls.from_ini(DP_INI)
    args.train_resolution = args.inference_resolution = RES
    args.batch_size = B
    args.rotation = args.scale = args.translate = args.shear = 0.0
    args.albu_prob = 0.0
    args.augment_multiplicity = 1
    args.max_grad_norm = 1e-3
    args.noise_multiplier = 0.0
    return args


def _model():
    torch.manual_seed(0)
    model = create_model(_args(Arguments), num_classes=3, device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():  # biases away from their zero init, a live head
        for conv in model.convs:
            conv.bias.normal_(0, 0.1, generator=g)
        model.classifier[-1].weight.normal_(0, 0.1, generator=g)
    return model


def _batch():
    rng = np.random.default_rng(1)
    imgs = rng.integers(0, 256, (B, RES, RES, 1), dtype=np.uint8)
    labels = rng.integers(0, 3, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0  # a padded row
    return imgs, labels, mask


def _use_views(monkeypatch):
    views = np.random.default_rng(2).normal(0, 1, (B, RES, RES, 1)).astype(np.float32)
    monkeypatch.setattr(jdp, "build_augment_fn",
                        lambda cfg, mean, std, ch: lambda key, imgs: jnp.asarray(views))
    port_x = torch.from_numpy(views.transpose(0, 3, 1, 2).copy())
    monkeypatch.setattr(dp, "build_augment_fn",
                        lambda cfg, mean, std, ch, device="cpu": lambda gen, imgs: port_x)


class _Recorder:
    """Stands in for the optimizer: keeps the gradients it is given."""

    def __init__(self, model):
        self.names = [n for n, _ in param_leaves(model)]
        named = dict(model.named_parameters())
        self.params = [named[n] for n in self.names]

    def update(self, grads, lr):
        self.grads = dict(zip(self.names, (g.clone() for g in grads)))


class _JaxRecorder:
    """The JAX step's optimizer: its new parameters are the gradients."""

    @staticmethod
    def init(params):
        return ()

    @staticmethod
    def update(grads, state, params, lr):
        return grads, state


def _port_grads(make_step, model, monkeypatch, **kw):
    """(the clipped, averaged gradient by name, each example's squared
    norm) of one port step."""
    norms = []
    clip = dp._clip_factor
    monkeypatch.setattr(dp, "_clip_factor", lambda sq, c, m: norms.append(sq) or clip(sq, c, m))
    rec = _Recorder(model)
    make_step(model, rec, _args(Arguments), MEAN, STD, None, "cpu", **kw)(
        torch.Generator().manual_seed(0), *_batch(), 1.0)
    return rec.grads, torch.cat(norms)[:B]


def test_ghost_norms_count_the_conv_biases_as_the_microbatched_step(monkeypatch):
    """Each example's squared gradient norm, biases included, from the
    ghost step's closed forms against the microbatched step's per-example
    gradients: within 1e-5 relative; the clipped sums within 1e-5 of each
    leaf's max. The biases' share of the norm is far above that limit."""
    _use_views(monkeypatch)
    model = _model()
    g_ghost, sq_ghost = _port_grads(dp.build_ghost_dp_train_step, copy.deepcopy(model),
                                    monkeypatch)
    g_micro, sq_micro = _port_grads(dp.build_dp_train_step, copy.deepcopy(model), monkeypatch,
                                    microbatch=4)
    torch.testing.assert_close(sq_ghost, sq_micro, rtol=1e-5, atol=0)
    bias_sq = sum(g_micro[f"convs.{i}.bias"].square().sum() for i in range(6))
    assert bias_sq > 1e-3 * sum(g.square().sum() for g in g_micro.values())
    for n, ref in g_micro.items():
        torch.testing.assert_close(g_ghost[n], ref, rtol=0, atol=1e-5 * float(ref.abs().max()),
                                   msg=n)


def test_ghost_clipped_sum_matches_the_jax_ghost_step(monkeypatch):
    """Against ``primia_tpu/train/dp.py:build_ghost_dp_train_step`` from the
    same weights and views: every leaf within 1e-5 of its max |g|, except
    the weights of the four convs with more than 256 output pixels, which
    take the per-tap form: the JAX package rounds their per-example
    gradients and the clip factors to bfloat16 before the sum (ADVICE.md)
    and the port keeps float32, so those are held to 2^-7 of their max,
    two bfloat16 roundings of 2^-8 (measured: 3.5e-3 to 4.2e-3)."""
    _use_views(monkeypatch)
    model = _model()
    got, _ = _port_grads(dp.build_ghost_dp_train_step, copy.deepcopy(model), monkeypatch)
    params, state = to_jax_tree(model)
    md = jax_create_model(_args(JaxArguments), num_classes=3)
    step = jdp.build_ghost_dp_train_step(md, _JaxRecorder, _args(JaxArguments), MEAN, STD,
                                         donate=False)
    ts, _ = step(TrainState(params, state, ()), KEY, *(jnp.asarray(a) for a in _batch()), 1.0)
    ref = from_jax_tree(jax.device_get(ts.params), {})
    assert set(ref) == set(got) and len(got) == 18
    for n, r in ref.items():
        tol = 2.0 ** -7 if n in {f"convs.{i}.weight" for i in range(4)} else 1e-5
        torch.testing.assert_close(got[n], r, rtol=0, atol=tol * float(r.abs().max()), msg=n)


def _cut_ini(tmp_path, src, cuts):
    text = src.read_text()
    for old, new in cuts:
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / src.name
    ini.write_text(text)
    return ini


def test_conv_dp_recipes_train_through_the_cli(tmp_path, fixture_dir, monkeypatch, capsys):
    """``pneumonia-conv-dp.ini`` at its 224 px (SimpleConv, group norm, K =
    4: the microbatched step under ``torch.func.vmap``), one epoch of one
    step (batch 12, the fixture's 12 images); then
    ``pneumonia-conv-dp-federated.ini`` at 224 px, batch 12, K cut from 16
    to 2, on three workers of the fixture (one step a node, one secure
    aggregation): each prints its epsilon line and saves the EMA checkpoint
    with the raw parameters beside it."""
    from primia_tpu_torch.cli.train import main as port_train
    from primia_tpu_torch.train import checkpoint as ckpt

    monkeypatch.chdir(tmp_path)
    ini = _cut_ini(tmp_path, DP_INI, (("batch_size = 512", "batch_size = 12"),
                                      ("epochs = 60", "epochs = 1"),
                                      ("test_interval = 2", "test_interval = 1")))
    best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                       "--device", "cpu"])
    assert np.isfinite(best) and "(eps = " in capsys.readouterr().out
    final = ckpt.load_model(sorted((tmp_path / "model_weights").glob("final_*.pt"))[0])
    assert sorted(final["raw_params"]["bns"]) == ["0", "1", "3"]

    fed = tmp_path / "fed"
    fed.mkdir()
    for w in ("worker1", "worker2", "worker3"):
        (fed / w).symlink_to(fixture_dir / "train", target_is_directory=True)
    (fed / "validation").symlink_to(fixture_dir / "test", target_is_directory=True)
    ini = _cut_ini(tmp_path / "fed", DP_FED_INI, (("batch_size = 512", "batch_size = 12"),
                                                  ("epochs = 60", "epochs = 1"),
                                                  ("test_interval = 2", "test_interval = 1"),
                                                  ("augment_multiplicity = 16",
                                                   "augment_multiplicity = 2")))
    best = port_train(["--config", str(ini), "--data_dir", str(fed), "--train_federated",
                       "--device", "cpu"])
    assert np.isfinite(best)
    assert "[worst node: worker" in capsys.readouterr().out
