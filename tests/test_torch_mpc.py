"""The port's MPC stack against the JAX package: fixed point, shares,
ring products, the FSS comparison, the engine's ops and encrypted
inference end to end.

Integer code is held bit for bit (fixed-point encode and truncation, ring
products). Shares come from different random streams in the two
packages, so share-space results are held after reveal: the engine's ops
at JAX's own tolerance (atol 1e-3, ``tests/test_mpc.py``), encrypted
logits against the plain predict step at 0.02 with equal argmax. Inputs
are numpy draws handed to both sides; JAX runs with x64 on, so dtypes are
pinned.
"""

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.mpc import fixed as jfixed
from primia_tpu.mpc import ring_ops as jring
from primia_tpu.mpc import shares as JS
from primia_tpu.mpc.engine import MpcContext as JaxContext
from primia_tpu.mpc.engine import MpcEngine as JaxEngine
from primia_tpu.mpc.engine import reveal_and_decode as jax_reveal
from primia_tpu.nn import create_model as jax_create_model
from primia_tpu.nn.resnet import _basic_block_forward as jax_block_forward
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu.train.steps import build_predict_step as jax_build_predict_step
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.mpc import compare, fixed, ring_ops
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc import inference as mpc_inference
from primia_tpu_torch.mpc.engine import MpcContext, MpcEngine, encode_and_share, reveal_and_decode
from primia_tpu_torch.mpc.inference import (basic_block_forward, build_encrypted_predict,
                                            folded_weights)
from primia_tpu_torch.mpc.shares import AShare
from primia_tpu_torch.nn import create_model
from primia_tpu_torch.nn.jax_params import from_jax_tree
from primia_tpu_torch.nn.resnet import BasicBlock
from primia_tpu_torch.ops import cuda_clahe, cuda_dcf
from primia_tpu_torch.train.steps import build_predict_step

CANONICAL = (Path(__file__).resolve().parent.parent / "configs" / "torch"
             / "pneumonia-resnet-pretrained.ini")
RES = 32
MEAN_STD = (np.array([0.45, 0.46, 0.47]), np.array([0.22, 0.23, 0.24]))
TOL = 0.02  # tests/test_mpc.py's encrypted-inference tolerance


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


def _ring(rng, shape):
    return rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64, endpoint=True)


# ------------------------------------------------------------ fixed point

def test_encode_decode_and_truncation_match_jax():
    rng = np.random.default_rng(0)
    halves = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5]) / (1 << 16)  # ties: to even
    x = np.concatenate([halves, rng.normal(0, 100, 200), [0.0, -0.0, 3e4, -3e4]])
    got = fixed.encode(torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfixed.encode(jnp.asarray(x))))
    np.testing.assert_array_equal(fixed.decode(got).numpy(),
                                  np.asarray(jfixed.decode(jnp.asarray(got.numpy()))))
    sh = _ring(rng, (2, 300))
    np.testing.assert_array_equal(fixed.truncate_shares(torch.from_numpy(sh)).numpy(),
                                  np.asarray(jfixed.truncate_shares(jnp.asarray(sh))))
    np.testing.assert_array_equal(fixed.truncate_public(torch.from_numpy(sh[0])).numpy(),
                                  np.asarray(jfixed.truncate_public(jnp.asarray(sh[0]))))


def test_shares_cover_the_ring_and_reconstruct():
    gen = torch.Generator().manual_seed(1)
    r = S.rand_ring(gen, (4096,))
    assert r.dtype == torch.int64
    assert bool((r < 0).any()) and bool((r >= 0).any())  # bit 63 both ways
    assert int(((r >> 31) & 1).sum()) in range(1800, 2300)  # the low draw's top bit
    assert ((r >> 32) & 0xFFFF).unique().numel() > 3000  # the high draw varies
    v = torch.from_numpy(_ring(np.random.default_rng(2), (3, 5)))
    sv = S.share(gen, v)
    assert sv.shape == v.shape and torch.equal(S.reconstruct(sv), v)
    assert not torch.equal(sv.data[1], torch.zeros_like(v))
    moved = S.add_public(sv, 7)
    assert torch.equal(moved.data[1], sv.data[1]) and torch.equal(S.reconstruct(moved), v + 7)


# ----------------------------------------------------------- ring products

def test_limbs_match_jax():
    v = _ring(np.random.default_rng(3), (257,))
    v[:4] = [0, -1, -(1 << 63), (1 << 63) - 1]
    np.testing.assert_array_equal(ring_ops.to_limbs(torch.from_numpy(v)).numpy(),
                                  np.asarray(jring.to_limbs(jnp.asarray(v))))


@pytest.mark.parametrize("shape", [(1, 512, 3), (5, 147, 64), (33, 200, 17)],
                         ids=["fc_batch1", "stem_depth", "ragged"])
def test_ring_matmul_native_limbs_and_jax_agree(shape):
    M, K, N = shape
    rng = np.random.default_rng(4)
    a, b = _ring(rng, (M, K)), _ring(rng, (K, N))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    native = ring_ops.ring_matmul(ta, tb)
    np.testing.assert_array_equal(ring_ops.limb_matmul(ta, tb).numpy(), native.numpy())
    np.testing.assert_array_equal(native.numpy(), np.asarray(jring.ring_matmul(a, b)))


CONVS = [((1, 3, 32, 32), (64, 3, 7, 7), 2, 3), ((2, 8, 7, 7), (16, 8, 3, 3), 1, 1),
         ((2, 8, 8, 8), (16, 8, 1, 1), 2, 0), ((1, 16, 1, 1), (16, 16, 3, 3), 1, 1)]


@pytest.mark.parametrize("xs,ws,stride,pad", CONVS, ids=["stem", "3x3", "down", "1x1_input"])
def test_ring_conv2d_native_limbs_and_jax_agree(xs, ws, stride, pad):
    rng = np.random.default_rng(5)
    x, w = _ring(rng, xs), _ring(rng, ws)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    native = ring_ops.ring_conv2d(tx, tw, stride, pad)
    np.testing.assert_array_equal(ring_ops.limb_conv2d(tx, tw, stride, pad).numpy(),
                                  native.numpy())
    ref = jring.ring_conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                            jnp.asarray(w.transpose(2, 3, 1, 0)), stride, pad)
    np.testing.assert_array_equal(native.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))


# ------------------------------------------------------------- comparison

def test_sign_shares_reconstruct_to_the_sign():
    rng = np.random.default_rng(6)
    v = rng.integers(-(1 << 30), 1 << 30, (3, 5, 7), dtype=np.int64, endpoint=True)
    v.reshape(-1)[:8] = [0, -1, 1, 1 << 30, -(1 << 30), (1 << 30) - 1, -(1 << 30) + 1, -2]
    gen = torch.Generator().manual_seed(7)
    sv = S.share(gen, torch.from_numpy(v))
    before = dict(cuda_dcf.launches)
    sign = compare.sign_shares(gen, sv)
    assert sign.shape == v.shape
    np.testing.assert_array_equal(S.reconstruct(sign).numpy(), (v < 0).astype(np.int64))
    assert cuda_dcf.launches == before  # CPU tensors: the plain version


# ------------------------------------------------------------ engine ops

def _nhwc(a):
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _nchw(a):
    return a.transpose(0, 3, 1, 2) if a.ndim == 4 else a


class _Both:
    """Shares the same numpy values in both packages."""

    def __init__(self, seed):
        self.jkey = jax.random.PRNGKey(seed)
        self.gen = torch.Generator().manual_seed(seed)
        self.n = 0

    def jax(self, a):
        self.n += 1
        return JS.share(jax.random.fold_in(self.jkey, self.n),
                        jfixed.encode(jnp.asarray(a, jnp.float64)))

    def port(self, a):
        return S.share(self.gen, fixed.encode(torch.from_numpy(np.asarray(a, np.float64))))


def _engines(seed):
    return (JaxEngine(JaxContext(jax.random.PRNGKey(seed), protocol="fss")),
            MpcEngine(MpcContext(torch.Generator().manual_seed(seed), protocol="fss")))


def _block_case(rng):
    torch.manual_seed(0)
    block = BasicBlock(4, 8, 2, "batch").eval()
    for m in (block.bn1, block.bn2, block.down_bn):
        m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, 8)))
        m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
        m.weight.data.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8)))
    return block


def _op_case(op, rng, both, E):
    """The JAX engine's op and its sharings, the port's revealed result
    and the plaintext reference (NCHW)."""
    x = rng.uniform(-2, 2, (2, 4, 6, 6))
    jx, tx = both.jax(_nhwc(x)), both.port(x)
    if op == "conv2d":
        w = rng.normal(0, 0.3, (8, 4, 3, 3))
        jfn, jargs = (lambda J, a, b: J.conv2d(a, b, stride=2, padding=1),
                      (jx, both.jax(w.transpose(2, 3, 1, 0))))
        p = E.conv2d(tx, both.port(w), 2, 1)
        ref = torch.nn.functional.conv2d(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                                         padding=1).numpy()
    elif op == "affine":
        scale, off = rng.uniform(0.5, 2, 4), rng.uniform(-1, 1, 4)
        jfn, jargs = (lambda J, *a: J.affine(*a)), (jx, both.jax(scale), both.jax(off))
        p = E.affine(tx, both.port(scale), both.port(off))
        ref = x * scale[:, None, None] + off[:, None, None]
    elif op == "relu":
        jfn, jargs = (lambda J, a: J.relu(a)), (jx,)
        p, ref = E.relu(tx), np.maximum(x, 0)
    elif op == "max_pool":
        jfn, jargs = (lambda J, a: J.max_pool(a, 3, 2, 1)), (jx,)
        p = E.max_pool(tx, 3, 2, 1)
        ref = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2, 1).numpy()
    elif op == "avg_pool":
        jfn, jargs = (lambda J, a: J.avg_pool(a, 2, 2)), (jx,)
        p = E.avg_pool(tx, 2, 2)
        ref = torch.nn.functional.avg_pool2d(torch.from_numpy(x), 2, 2).numpy()
    elif op == "linear":
        x2 = x.reshape(2, -1)
        w, b = rng.normal(0, 0.1, (3, x2.shape[1])), rng.uniform(-1, 1, 3)
        jfn, jargs = (lambda J, *a: J.linear(*a)), (both.jax(x2), both.jax(w.T), both.jax(b))
        p = E.linear(both.port(x2), both.port(w), both.port(b))
        ref = x2 @ w.T + b
    else:  # one BasicBlock with a downsample, BN folded
        block = _block_case(rng)
        jp = {}
        for k, v in folded_weights(block).items():
            mod, leaf = k.split(".")
            v = v.double().numpy()
            jp.setdefault(mod, {})["w" if leaf == "weight" else leaf] = both.jax(
                v.transpose(2, 3, 1, 0) if v.ndim == 4 else v)
        jfn, jargs = (lambda J, p, a: jax_block_forward(p, {}, a, E=J, train=False,
                                                        stride=2)[0]), (jp, jx)
        p = basic_block_forward(E, encode_and_share(both.gen, folded_weights(block)), block, "",
                                tx)
        with torch.no_grad():
            ref = block(torch.from_numpy(x).float()).double().numpy()
    return jfn, jargs, reveal_and_decode(p).numpy(), ref


@pytest.mark.parametrize("op", ["conv2d", "affine", "relu", "max_pool", "avg_pool", "linear",
                                "basic_block"])
def test_engine_op_matches_jax_engine(op):
    """Both engines with the FSS comparison; the JAX op jitted (eager, each
    of its comparisons compiles its scans anew)."""
    jfn, jargs, p, ref = _op_case(op, np.random.default_rng(8), _Both(10),
                                  MpcEngine(MpcContext(torch.Generator().manual_seed(9),
                                                       protocol="fss")))
    run = jax.jit(lambda key, a: jfn(JaxEngine(JaxContext(key, protocol="fss")), *a))
    j = _nchw(np.asarray(jax_reveal(run(jax.random.PRNGKey(9), jargs))))
    assert p.shape == j.shape == ref.shape
    np.testing.assert_allclose(p, j, atol=1e-3, rtol=0)
    np.testing.assert_allclose(p, ref, atol=1e-3, rtol=0)


def test_engine_rejects_what_is_not_ported():
    """An unknown protocol raises; SecureNN (the default, as in the JAX
    package) and a group-norm model build."""
    with pytest.raises(ValueError, match="unknown MPC protocol"):
        MpcContext(torch.Generator(), protocol="aby3")
    assert MpcContext(torch.Generator()).protocol == "snn"
    assert MpcContext(torch.Generator(), protocol="fss").protocol == "fss"
    args = Arguments.from_ini(CANONICAL)
    args.normalization = "group"
    model = create_model(args, num_classes=3, device="cpu")
    assert callable(build_encrypted_predict(model, args, *MEAN_STD, "cpu"))
    with pytest.raises(ValueError, match="unknown MPC protocol"):
        build_encrypted_predict(model, args, *MEAN_STD, "cpu", protocol="aby3")


@pytest.mark.parametrize("protocol", ["snn", "fss"])
def test_relu_and_max_pool_under_both_protocols(protocol):
    """The engine's comparisons through SecureNN and through the FSS
    comparison: relu and the max pool within 1e-3 of plaintext."""
    rng = np.random.default_rng(14)
    x = rng.uniform(-2, 2, (2, 4, 6, 6))
    both = _Both(15)
    E = MpcEngine(MpcContext(torch.Generator().manual_seed(16), protocol=protocol))
    tx = both.port(x)
    np.testing.assert_allclose(reveal_and_decode(E.relu(tx)).numpy(), np.maximum(x, 0),
                               atol=1e-3, rtol=0)
    want = torch.nn.functional.max_pool2d(torch.from_numpy(x), 3, 2, 1).numpy()
    np.testing.assert_allclose(reveal_and_decode(E.max_pool(tx, 3, 2, 1)).numpy(), want,
                               atol=1e-3, rtol=0)


def _group_norm_case(shape, groups, seed=5):
    """x ~ N(0.5, 1.5) NHWC with gamma ~ N(1, 0.2), beta ~ N(0, 0.2)
    (``tests/test_mpc.py``'s case): the JAX engine's private group norm,
    the port's, and the plain one, NHWC."""
    from primia_tpu.nn.core import PLAIN
    from primia_tpu.nn.core import group_norm as jax_group_norm

    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 1.5, shape).astype(np.float32)
    C = shape[-1]
    gamma = rng.normal(1.0, 0.2, C).astype(np.float32)
    beta = rng.normal(0.0, 0.2, C).astype(np.float32)
    plain = np.asarray(jax_group_norm(PLAIN, jnp.asarray(x), {
        "gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}, groups=groups))
    both = _Both(seed)
    J, E = _engines(seed)
    j = np.asarray(jax_reveal(J.group_norm(both.jax(x), both.jax(gamma), both.jax(beta),
                                           groups=groups)))
    p = reveal_and_decode(E.group_norm(both.port(_nchw(x)), both.port(gamma), both.port(beta),
                                       groups=groups)).numpy()
    return _nhwc(p), j, plain


def test_engine_group_norm_matches_jax():
    """3 x 6 x 6 x 32 in 8 groups (``tests/test_mpc.py:408``): within the
    JAX test's 0.03 of the JAX engine and within 1e-3 of plaintext; the
    port's NCHW groups (B, G, C/G * H * W) are the JAX package's NHWC
    groups of neighbouring channels."""
    p, j, plain = _group_norm_case((3, 6, 6, 32), 8)
    assert p.shape == plain.shape
    np.testing.assert_allclose(p, j, atol=0.03, rtol=0)
    np.testing.assert_allclose(p, plain, atol=1e-3, rtol=0)


def test_group_norm_divides_by_the_count_exactly():
    """The deviation on purpose: at the 224 px stem's 1 x 112 x 112 x 64 in
    32 groups, n = 25,088, and the JAX engine's ``encode(1 / n)`` (3 for
    2.61 at 16 bits) puts it more than 0.3 off plaintext; the port divides
    by n exactly (``functions.div_public_int``) and stays within 2e-3."""
    p, j, plain = _group_norm_case((1, 112, 112, 64), 32)
    assert np.abs(j - plain).max() > 0.3
    np.testing.assert_allclose(p, plain, atol=2e-3, rtol=0)
    with pytest.raises(ValueError, match="not divisible"):
        _engines(0)[1].group_norm(AShare(torch.zeros(2, 1, 6, 2, 2, dtype=torch.int64)),
                                  *[AShare(torch.zeros(2, 6, dtype=torch.int64))] * 2, groups=4)


# ------------------------------------------------------ the slice, end to end

def _with_stats(state, rng):
    """The init's BN statistics (mean 0, var 1) replaced by varied ones."""
    if isinstance(state, list):
        return [_with_stats(s, rng) for s in state]
    if set(state) == {"mean", "var", "count"}:
        n = state["mean"].shape[0]
        return {"mean": rng.normal(0, 0.1, n).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32), "count": state["count"]}
    return {k: _with_stats(v, rng) for k, v in state.items()}


@pytest.fixture(scope="module")
def slice_case():
    """ResNet-18 of the canonical recipe (3 channels, CLAHE on) at 32 px,
    from JAX params; three images; JAX's plain logits for them."""
    jargs = JaxArguments.from_ini(CANONICAL)
    jargs.train_resolution = jargs.inference_resolution = RES
    with pytest.warns(UserWarning, match="pretrained"):
        md = jax_create_model(jargs, num_classes=3)
    params, state = md.init(jax.random.PRNGKey(0))
    state = _with_stats(state, np.random.default_rng(11))
    args = Arguments.from_ini(CANONICAL)
    args.train_resolution = args.inference_resolution = RES
    model = create_model(args, num_classes=3, device="cpu")
    model.load_state_dict(from_jax_tree(params, state))
    imgs = np.random.default_rng(12).integers(0, 256, (3, RES, RES, 3), dtype=np.uint8)
    plain = np.asarray(jax_build_predict_step(md, jargs, *MEAN_STD)(params, state, imgs))
    return dict(jargs=jargs, md=md, params=params, state=state, args=args, model=model,
                imgs=imgs, plain=plain)


def _assert_close_logits(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert got.argmax(1).tolist() == want.argmax(1).tolist()


def test_encrypted_predict_matches_plain_jax(slice_case):
    c = slice_case
    before = dict(cuda_clahe.launches)
    predict = build_encrypted_predict(c["model"], c["args"], *MEAN_STD, "cpu", protocol="fss")
    _assert_close_logits(predict(c["imgs"][:2]).numpy(), c["plain"][:2])
    assert cuda_clahe.launches == before


def test_encrypted_predict_batch_tile(slice_case):
    """Tiles of 2 over 3 images: the tail padded and sliced off, a fresh
    dealer stream per tile."""
    c = slice_case
    predict = build_encrypted_predict(c["model"], c["args"], *MEAN_STD, "cpu", protocol="fss",
                                      batch_tile=2)
    _assert_close_logits(predict(c["imgs"]).numpy(), c["plain"])


def test_encrypted_predict_draws_fresh_streams_per_call(monkeypatch):
    """Every call and every tile masks its images and draws its dealer
    material anew: the parties open x - a, so a mask reused over two
    batches would reveal their difference."""
    seen = []

    def spy(E, P, model, xs, swap):
        seen.append((xs.data[1].clone(), S.rand_ring(E.ctx.gen, (8,))))
        return AShare(torch.zeros((2, xs.shape[0], 3), dtype=torch.int64))

    monkeypatch.setattr(mpc_inference, "resnet_forward", spy)
    args = Arguments.from_ini(CANONICAL)
    args.train_resolution = args.inference_resolution = RES
    model = create_model(args, num_classes=3, device="cpu")
    img = np.random.default_rng(13).integers(0, 256, (1, RES, RES, 3), dtype=np.uint8)
    predict = build_encrypted_predict(model, args, *MEAN_STD, "cpu", batch_tile=1)
    for _ in range(2):
        assert predict(np.concatenate([img, img])).shape == (2, 3)
    assert len(seen) == 4  # two calls of two tiles, the same image in each
    for i in range(4):
        for j in range(i):
            assert not torch.equal(seen[i][0], seen[j][0])
            assert not torch.equal(seen[i][1], seen[j][1])


def test_encrypted_inference_cli_on_cpu(slice_case, fixture_dir, tmp_path, capsys):
    from primia_tpu_torch.cli.inference import main

    c = slice_case
    path = tmp_path / "jax32.pt"
    jax_ckpt.save_model(path, epoch=1, params=c["params"], model_state=c["state"],
                        opt_state=None, args=c["jargs"], val_mean_std=MEAN_STD)
    data = tmp_path / "two"  # two of the fixture's images keep the test quick
    data.mkdir()
    for f in sorted((fixture_dir / "test" / "normal").iterdir())[:2]:
        shutil.copy(f, data / f.name)
    argv = ["--data_dir", str(data), "--model_weights", str(path), "--batch_size", "2"]
    got = main(argv + ["--encrypted_inference", "--device", "cpu"])["Inference Results"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith("Counter(") and lines[-1].startswith("Took ")
    # the plain step on the same images: equal wherever its top-two margin
    # is above the tolerance
    from primia_tpu_torch.data import PathDataset

    imgs, _ = PathDataset(data, channels=3).materialize(RES)
    plain = build_predict_step(c["model"], c["args"], *MEAN_STD, "cpu")(imgs).numpy()
    top2 = np.sort(plain, 1)[:, -2:]
    assert len(got) == 2
    for i, p in got.items():
        assert p == plain[i].argmax() or top2[i, 1] - top2[i, 0] <= TOL
    # SecureNN, the other protocol, gives the same predictions there
    snn = main(argv + ["--encrypted_inference", "--protocol", "snn", "--device", "cpu"])
    for i, p in snn["Inference Results"].items():
        assert p == plain[i].argmax() or top2[i, 1] - top2[i, 0] <= TOL


def test_encrypted_cli_defaults_to_cuda_and_raises_without_one(monkeypatch, tmp_path):
    from primia_tpu_torch.cli import inference

    opts = inference.build_parser().parse_args(["--model_weights", "x", "--encrypted_inference"])
    assert opts.device == "cuda" and opts.protocol == "fss" and opts.mpc_batch_tile is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inference.run(opts)


@pytest.mark.slow
def test_encrypted_predict_matches_jax_encrypted_predict(slice_case):
    """Against ``build_encrypted_predict`` of the JAX package itself (its
    XLA compile takes minutes on the CPU)."""
    from primia_tpu.mpc.inference import build_encrypted_predict as jax_build

    c = slice_case
    ref = np.asarray(jax_build(c["md"], c["jargs"], *MEAN_STD, protocol="fss")(
        c["params"], c["state"], c["imgs"][:2]))
    got = build_encrypted_predict(c["model"], c["args"], *MEAN_STD, "cpu", protocol="fss")(
        c["imgs"][:2])
    _assert_close_logits(got.numpy(), ref)
    _assert_close_logits(ref, c["plain"][:2])
