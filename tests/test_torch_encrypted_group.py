"""Encrypted inference of group-norm models in the port, under both
protocols: the DP recipe's ResNet (``configs/torch/pneumonia-resnet-dp.ini``:
group norm, max pool, no CLAHE) served over shares with private group
norm (``mpc/engine.py:group_norm``).

A group model from the He init has a zero fc, so every logit is 0 and an
encrypted-against-plain check would prove nothing: the head here is
N(0, 0.1) (as ``tests/test_mpc.py``'s end-to-end case). Encrypted logits
are held to the plain step within 0.05 with equal argmax (that test's
limit); the plain step to the JAX package's within 1e-4.
"""

import shutil
from functools import partial
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import ModelDef
from primia_tpu.nn.resnet import resnet_forward
from primia_tpu.train.steps import build_predict_step as jax_build_predict_step
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc.inference import build_encrypted_predict
from primia_tpu_torch.nn import ResNet, create_model
from primia_tpu_torch.nn.jax_params import to_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.steps import build_predict_step

DP_INI = Path(__file__).resolve().parent.parent / "configs" / "torch" / "pneumonia-resnet-dp.ini"
RES = 32
LAYERS = (1, 1, 1, 1)
MEAN, STD = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.24, 0.23])
TOL = 0.05  # tests/test_mpc.py:test_encrypted_groupnorm_resnet_matches_plaintext


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    monkeypatch.delenv("PRIMIA_MPC_DEBUG_DOMAINS", raising=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Share-space code is thousands of small integer ops: under the
    suite's parallel workers, intra-op threads only wait on each other
    (tens of times slower than one thread), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(cls):
    args = cls.from_ini(DP_INI)
    args.train_resolution = args.inference_resolution = RES
    return args


def _with_head(model, seed=9):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.fc.weight.normal_(0, 0.1, generator=g)
    return model.eval()


@pytest.fixture(scope="module")
def group_case():
    torch.manual_seed(0)
    model = _with_head(ResNet(LAYERS, num_classes=3, in_channels=3, input_size=RES,
                              norm="group"))
    args = _args(Arguments)
    imgs = np.random.default_rng(11).integers(0, 256, (2, RES, RES, 3), dtype=np.uint8)
    plain = build_predict_step(model, args, MEAN, STD, "cpu")(imgs).numpy()
    return dict(model=model, args=args, imgs=imgs, plain=plain)


def _assert_close_logits(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.argmax(1).tolist() == want.argmax(1).tolist()


def _jax_model(model):
    params, state = to_jax_tree(model)
    fwd = partial(resnet_forward, layers=LAYERS, pooling="max", input_size=RES, norm="group")
    return ModelDef("resnet-18", None, fwd, RES, 3, 3, "max"), params, state


def test_plain_group_model_matches_jax(group_case):
    c = group_case
    md, params, state = _jax_model(c["model"])
    ref = np.asarray(jax_build_predict_step(md, _args(JaxArguments), MEAN, STD)(
        params, state, c["imgs"]))
    np.testing.assert_allclose(c["plain"], ref, atol=1e-4, rtol=0)
    assert np.abs(c["plain"]).max() > 0.5  # the head is not the zero init


@pytest.mark.parametrize("protocol", ["snn", "fss"])
def test_encrypted_group_resnet_matches_plain(group_case, protocol):
    c = group_case
    predict = build_encrypted_predict(c["model"], c["args"], MEAN, STD, "cpu", protocol=protocol)
    _assert_close_logits(predict(c["imgs"]).numpy(), c["plain"])


@pytest.mark.slow
def test_encrypted_group_resnet_matches_jax_encrypted_predict(group_case):
    """Against the JAX package's own ``build_encrypted_predict`` (SecureNN)
    on the same weights, eagerly: about 90 s on the CPU (its jitted form
    compiles for about 11 minutes)."""
    from primia_tpu.mpc.inference import build_encrypted_predict as jax_build

    c = group_case
    md, params, state = _jax_model(c["model"])
    with jax.disable_jit():
        ref = np.asarray(jax_build(md, _args(JaxArguments), MEAN, STD, seed=1)(
            params, state, c["imgs"]))
    got = build_encrypted_predict(c["model"], c["args"], MEAN, STD, "cpu")(c["imgs"]).numpy()
    _assert_close_logits(got, ref)


def test_group_model_at_224_px_and_inverse_sqrt_domain(monkeypatch):
    """The DP recipe's ResNet-18 at full width (224 px, He init, an N(0, 0.1)
    head) on one synthetic X-ray (a bright blob on a dark field), encrypted
    under SecureNN on the CPU: the operands of the 20 private group norms'
    ``inverse_sqrt`` (var + eps) all lie in [1e-3, 10], but the stem's
    flattest groups fall below its documented domain [1e-2, 200], which
    ``PRIMIA_MPC_DEBUG_DOMAINS=1`` reports; the logits stay within 0.02 of
    the plain step all the same (seven Newton steps still converge
    there)."""
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc import functions as Fn
    from primia_tpu_torch.mpc import shares as S

    args = Arguments.from_ini(DP_INI)
    torch.manual_seed(0)
    model = _with_head(create_model(args, num_classes=3, device="cpu"))
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:224, 0:224]
    img = 40 + 150 * np.exp(-((yy - 112) ** 2 + (xx - 100) ** 2) / (2 * 60 ** 2))
    img = np.clip(img + rng.normal(0, 12, (224, 224)), 0, 255).astype(np.uint8)
    imgs = np.repeat(img[None, :, :, None], 3, axis=3)
    mean, std = np.full(3, 0.5), np.full(3, 0.25)
    seen = []
    rsqrt = Fn.inverse_sqrt

    def spy(ctx, x, iterations=7):
        seen.append(fixed.decode(S.reconstruct(x)))
        return rsqrt(ctx, x, iterations)

    monkeypatch.setattr(Fn, "inverse_sqrt", spy)
    plain = build_predict_step(model, args, mean, std, "cpu")(imgs).numpy()
    got = build_encrypted_predict(model, args, mean, std, "cpu")(imgs).numpy()
    np.testing.assert_allclose(got, plain, atol=0.02, rtol=0)
    assert got.argmax(1).tolist() == plain.argmax(1).tolist()
    assert len(seen) == 20 and all(v.shape == (1, 32, 1) for v in seen)
    lo, hi = min(float(v.min()) for v in seen), max(float(v.max()) for v in seen)
    assert 1e-3 < lo < 1e-2 and hi < 10, (lo, hi)
    assert all(float(v.min()) >= 1e-2 for v in seen[1:])  # only the stem's
    monkeypatch.setenv("PRIMIA_MPC_DEBUG_DOMAINS", "1")
    with pytest.raises(FloatingPointError, match="inverse_sqrt"):
        build_encrypted_predict(model, args, mean, std, "cpu")(imgs)


def test_encrypted_inference_cli_serves_a_group_checkpoint(fixture_dir, tmp_path, capsys):
    """The DP recipe's ResNet-18 checkpoint (group norm, a random head)
    through ``--encrypted_inference`` under both protocols on two fixture
    images: the plain step's prediction wherever its top-two margin is
    above the limit."""
    from primia_tpu_torch.cli.inference import main
    from primia_tpu_torch.data import PathDataset

    args = _args(Arguments)
    torch.manual_seed(5)
    model = _with_head(create_model(args, num_classes=3, device="cpu"))
    assert all(m.kind == "group" for m in model.modules() if hasattr(m, "kind"))
    path = tmp_path / "group32.pt"
    ckpt.save_model(path, epoch=1, model=model, args=args, val_mean_std=(MEAN, STD))
    data = tmp_path / "two"
    data.mkdir()
    for f in sorted((fixture_dir / "test" / "normal").iterdir())[:2]:
        shutil.copy(f, data / f.name)
    imgs, _ = PathDataset(data, channels=3).materialize(RES)
    plain = build_predict_step(model, args, MEAN, STD, "cpu")(imgs).numpy()
    top2 = np.sort(plain, 1)[:, -2:]
    argv = ["--data_dir", str(data), "--model_weights", str(path), "--batch_size", "2",
            "--encrypted_inference", "--device", "cpu"]
    for protocol in ("snn", "fss"):
        got = main(argv + ["--protocol", protocol])["Inference Results"]
        assert capsys.readouterr().out.splitlines()[-1].startswith("Took ")
        assert len(got) == 2
        for i, p in got.items():
            assert p == plain[i].argmax() or top2[i, 1] - top2[i, 0] <= TOL
