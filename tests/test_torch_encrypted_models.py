"""Encrypted inference of VGG-16 and SimpleConv in the port, under both
protocols, against the port's plain predict step on the same weights:
the logits within 0.02 (``tests/test_mpc.py``'s tolerance), the argmax
equal. The classifier gets N(0, 0.1) weights (VGG's init of N(0, 0.01)
and a group-norm model's zero head leave logits too small for the check
to mean anything). Under fss the FSS comparison's plain version (K4's, on
the CPU) runs once for each ReLU and each max-pool round of a forward:
VGG-16 25 (15 ReLUs, 5 pools of 2 rounds), SimpleConv@28 14, @224 20;
none under snn.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc.inference import build_encrypted_predict
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import to_jax_tree
from primia_tpu_torch.ops import cuda_dcf
from primia_tpu_torch.train.steps import build_predict_step

TOL = 0.02
# (model, resolution, channels, normalization, batch, comparisons a forward under fss)
CASES = {"vgg32": ("vgg16", 32, 3, "batch", 1, 25),
         "conv28": ("simpleconv", 28, 1, "batch", 2, 14),
         "conv224_group": ("simpleconv", 224, 1, "group", 1, 20)}


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Share-space code is thousands of small integer ops: under the
    suite's parallel workers, intra-op threads only wait on each other
    (tens of times slower than one thread), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(cls, case):
    model, res, ch, norm, _, _ = CASES[case]
    return cls(model=model, pretrained=ch == 3, train_resolution=res, inference_resolution=res,
               pooling_type="max", normalization=norm, clahe=False)


def _case(case):
    """The port's model (seeded init, N(0, 0.1) classifier), its images,
    normalisation and plain logits."""
    _, res, ch, _, batch, _ = CASES[case]
    args = _args(Arguments, case)
    torch.manual_seed(7)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # pretrained = yes with no weights file
        model = create_model(args, num_classes=3, device="cpu")
    g = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for lin in model.classifier:
            lin.weight.normal_(0, 0.1, generator=g)
    imgs = np.random.default_rng(9).integers(0, 256, (batch, res, res, ch), dtype=np.uint8)
    mean, std = np.full(ch, 0.45), np.full(ch, 0.23)
    plain = build_predict_step(model, args, mean, std, "cpu")(imgs).numpy()
    return args, model, imgs, mean, std, plain


def _assert_close_logits(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(want).max() > 10 * TOL  # logits large enough for the check to bite
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.argmax(1).tolist() == want.argmax(1).tolist()


def _encrypted(case, protocol, monkeypatch):
    args, model, imgs, mean, std, plain = _case(case)
    calls = []
    plain_sign = cuda_dcf.dcf_sign_plain
    monkeypatch.setattr(cuda_dcf, "dcf_sign_plain",
                        lambda *a: calls.append(1) or plain_sign(*a))
    got = build_encrypted_predict(model, args, mean, std, "cpu", protocol=protocol)(imgs)
    _assert_close_logits(got.numpy(), plain)
    assert len(calls) == (CASES[case][5] if protocol == "fss" else 0)


@pytest.mark.parametrize("protocol", ["snn", "fss"])
@pytest.mark.parametrize("case", ["vgg32", "conv28"])
def test_encrypted_predict_matches_plain(case, protocol, monkeypatch):
    """VGG-16@32 at batch 1 and SimpleConv@28 at batch 2 (batch norm
    folded; SimpleConv@28 has none)."""
    _encrypted(case, protocol, monkeypatch)


@pytest.mark.slow
def test_encrypted_group_simpleconv_at_224_px(monkeypatch):
    """The DP recipe's model (SimpleConv@224, group norm, G = 8 at C = 8)
    on one image under fss, its three group norms private: slow, as the
    CPU's plain DCF walk takes about two minutes at 224 px
    (``chip_smoke.py`` phase 19 serves the same model under both protocols
    on the card)."""
    _encrypted("conv224_group", "fss", monkeypatch)


@pytest.mark.slow
def test_encrypted_vgg_matches_jax_encrypted_predict():
    """Against the JAX package's own ``build_encrypted_predict`` on the
    same weights, eagerly (its jitted form compiles for minutes), under
    both protocols. The two packages draw different masks, triples and
    keys, so the revealed logits agree within the fixed-point tolerance,
    not bit for bit (SecureNN's and the DCF's bits are held from explicit
    dealer keys in ``test_torch_securenn.py`` and ``test_torch_dcf.py``)."""
    from primia_tpu.mpc.inference import build_encrypted_predict as jax_build

    args, model, imgs, mean, std, plain = _case("vgg32")
    with pytest.warns(UserWarning, match="pretrained"):
        md = jax_create_model(_args(JaxArguments, "vgg32"), num_classes=3)
    params, state = to_jax_tree(model)
    for protocol in ("snn", "fss"):
        with jax.disable_jit():
            ref = np.asarray(jax_build(md, _args(JaxArguments, "vgg32"), mean, std,
                                       protocol=protocol)(params, state, imgs))
        got = build_encrypted_predict(model, args, mean, std, "cpu", protocol=protocol)(imgs)
        _assert_close_logits(got.numpy(), ref)
        _assert_close_logits(ref, plain)


def test_private_group_norm_holds_small_variances():
    """SimpleConv@224's first group norm has one channel a group, whose
    variance on an X-ray's flat field falls to a few 1e-3 (3e-3 on
    ``chip_smoke.py``'s synthetic X-rays): there seven Newton steps from
    ``inverse_sqrt``'s start leave rsqrt 5% low. The engine's norms take
    ``NORM_RSQRT_ITERATIONS`` (10) steps: channel variances from 2.5e-3 to
    1 normalise within 1e-2 of the plain group norm (seven steps: 0.07 off
    at 2.5e-3; at 1e-3 the fixed point's own error, times rsqrt's 32, is
    already about 1e-2)."""
    from primia_tpu_torch.mpc import engine
    from primia_tpu_torch.mpc import fixed
    from primia_tpu_torch.mpc import shares as S
    from primia_tpu_torch.mpc.engine import MpcContext, MpcEngine, encode_and_share
    from primia_tpu_torch.nn.core import group_norm

    g = torch.Generator().manual_seed(3)
    stds = torch.tensor([0.05, 0.06, 0.07, 0.1, 0.2, 0.5, 0.8, 1.0], dtype=torch.float64)
    x = torch.randn(2, 8, 20, 20, generator=g, dtype=torch.float64) * stds[:, None, None] + 0.3
    gamma, beta = torch.linspace(0.5, 1.5, 8), torch.linspace(-0.2, 0.2, 8)
    want = group_norm(x.float(), gamma, beta, groups=8)
    sh = encode_and_share(g, {"x": x, "gamma": gamma.double(), "beta": beta.double()})
    E = MpcEngine(MpcContext(torch.Generator().manual_seed(4), protocol="snn"))
    got = fixed.decode(S.reconstruct(E.group_norm(sh["x"], sh["gamma"], sh["beta"], groups=8)))
    assert engine.NORM_RSQRT_ITERATIONS == 10
    torch.testing.assert_close(got.float(), want, rtol=0, atol=1e-2)
