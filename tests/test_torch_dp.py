"""The port's DP-SGD slice against the JAX package: the RDP accountant, the
microbatched and the ghost-norm DP steps, the noise, the split group norm,
and DP training through both train CLIs, local and federated, on the CPU.

Inputs are numpy draws handed to both packages; the JAX steps draw their
augmentation from keys, the port's from a generator, so both are handed
the same explicit views (each package's ``build_augment_fn`` is replaced
in the test by one that returns them). Float32 on both sides. Each test
states its limit.
"""

import copy
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.train.dp as jdp
import primia_tpu_torch.train.dp as dp
from primia_tpu.config import Arguments as JaxArguments
from primia_tpu.nn import ModelDef
from primia_tpu.nn.core import PLAIN
from primia_tpu.nn.core import group_norm as jax_group_norm
from primia_tpu.nn.resnet import resnet_forward
from primia_tpu.train import checkpoint as jax_ckpt
from primia_tpu.train import optim as jax_optim
from primia_tpu.train.steps import TrainState
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import ResNet
from primia_tpu_torch.nn.core import _channel, group_norm, group_normalize
from primia_tpu_torch.nn.jax_params import from_jax_tree, to_jax_tree
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.optim import make_optimizer

ROOT = Path(__file__).resolve().parent.parent
DP_INI = ROOT / "configs" / "torch" / "pneumonia-resnet-dp.ini"
DP_FED_INI = ROOT / "configs" / "torch" / "pneumonia-resnet-dp-federated.ini"
RES = 32
LAYERS = (1, 1, 1, 1)
MEAN, STD = np.array([0.5, 0.45, 0.4]), np.array([0.25, 0.24, 0.23])
KEY = jax.random.PRNGKey(3)  # the JAX steps' key
# a learning rate that moves the parameters (|p| <= 0.1) by about 1e-2
# at clip 1e-3: updates far above a parameter's float32 ulp, so the
# update's rounding into p stays below the limits
LR = 1000.0


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_materialize_cache(monkeypatch):
    monkeypatch.setenv("PRIMIA_MATERIALIZE_CACHE", "0")
    monkeypatch.delenv("PRIMIA_DP_GHOST", raising=False)
    monkeypatch.delenv("PRIMIA_DP_SECURE_NOISE", raising=False)
    monkeypatch.delenv("PRIMIA_PALLAS_WGRAD", raising=False)


# ------------------------------------------------------------ accountant

def test_rdp_accountant_matches_jax():
    """``rdp_sampled_gaussian`` over a grid of q, sigma and alpha (q = 0 and
    q = 1 included) and ``rdp_epsilon`` over sigma, q and steps (sigma = 0
    gives (inf, None); the canonical INI's q = 512 / N, sigma = 2.0, 600
    steps): within 1e-9, the best alpha equal."""
    for q in (0.0, 1e-3, 0.02, 512 / 5216, 0.5, 1.0):
        for sigma in (0.5, 1.3, 2.0, 3.0, 8.0):
            for alpha in (2, 3, 10, 32, 64, 128, 256):
                assert dp.rdp_sampled_gaussian(q, sigma, alpha) == pytest.approx(
                    jdp.rdp_sampled_gaussian(q, sigma, alpha), rel=1e-9, abs=1e-9)
    for sigma in (0.0, 0.8, 1.3, 2.0, 3.0):
        for q, steps in ((512 / 5216, 600), (0.01, 1), (0.1, 10_000), (1.0, 5)):
            for delta in (1e-5, 1e-6):
                kw = dict(noise_multiplier=sigma, sample_rate=q, steps=steps, delta=delta)
                eps, alpha = dp.rdp_epsilon(**kw)
                ref_eps, ref_alpha = jdp.rdp_epsilon(**kw)
                assert alpha == ref_alpha
                assert eps == pytest.approx(ref_eps, rel=1e-9, abs=1e-9)
    assert dp.rdp_epsilon(noise_multiplier=0.0, sample_rate=0.1, steps=3) == (float("inf"),
                                                                             None)
    assert dp.DEFAULT_ALPHAS == jdp.DEFAULT_ALPHAS


# -------------------------------------------------------------- the steps

def _args(cls, K=1, clip=1e-3, sigma=0.0, res=RES):
    """The DP INI at ``res`` px, batch 6, augmentation off (the tests hand
    both packages explicit views), float32."""
    args = cls.from_ini(DP_INI)
    args.train_resolution = args.inference_resolution = res
    args.batch_size = 6
    args.rotation = args.scale = args.translate = args.shear = 0.0
    args.albu_prob = 0.0
    args.augment_multiplicity = K
    args.max_grad_norm = clip
    args.noise_multiplier = sigma
    return args


def _model(seed=0, norm="group", res=RES):
    torch.manual_seed(seed)
    m = ResNet(LAYERS, num_classes=3, in_channels=3, input_size=res, norm=norm)
    if norm == "batch":  # running statistics away from (0, 1)
        g = torch.Generator().manual_seed(seed)
        for mod in m.modules():
            if hasattr(mod, "running_var"):
                mod.running_mean.normal_(0, 0.1, generator=g)
                mod.running_var.uniform_(0.5, 1.5, generator=g)
    return m


def _batch(B=6, seed=1, res=RES):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, res, res, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, B).astype(np.int32)
    mask = np.ones(B, np.float32)
    mask[-1] = 0.0  # a padded row
    return imgs, labels, mask


def _views(K, B=6, seed=2, res=RES):
    """K explicit augmented views of B examples, NHWC float32 (K, B, H, W, C)."""
    return np.random.default_rng(seed).normal(0, 1, (K, B, res, res, 3)).astype(np.float32)


def _use_views(monkeypatch, views):
    """Both packages' augmentation returns ``views``: the JAX step's K keys
    (split from its augmentation key) pick view k; the port's K x B stack,
    example-major, is the views in that order."""
    K, B, res = views.shape[:3]
    jv = jnp.asarray(views)

    def jax_fn(cfg, mean, std, channels):
        def augment(key, imgs):
            if K == 1:
                return jv[0]
            keys = jax.random.split(jax.random.split(KEY)[0], K)
            idx = sum(j * jnp.all(key == keys[j]).astype(jnp.int32) for j in range(K))
            return jv[idx]
        return augment

    port_x = torch.from_numpy(views.transpose(1, 0, 4, 2, 3).reshape(B * K, 3, res, res).copy())

    def port_fn(cfg, mean, std, channels, device="cpu"):
        return lambda gen, imgs: port_x.contiguous(memory_format=torch.channels_last)

    monkeypatch.setattr(jdp, "build_augment_fn", jax_fn)
    monkeypatch.setattr(dp, "build_augment_fn", port_fn)


def _jax_model_def(norm, res):
    fwd = partial(resnet_forward, layers=LAYERS, pooling="max", input_size=res, norm=norm)
    return ModelDef("resnet-18", None, fwd, res, 3, 3, "max")


def _jax_step(make_step, model, args, batch, lr, norm="group", **kw):
    """One JAX DP step from ``model``'s weights; returns (params, loss)."""
    params, state = to_jax_tree(model)
    opt = jax_optim.sgd(args.momentum, args.weight_decay)
    step = make_step(_jax_model_def(norm, args.train_resolution), opt, args, MEAN, STD,
                   donate=False, **kw)
    imgs, labels, mask = batch
    ts, loss = step(TrainState(params, state, opt.init(params)), KEY,
                    jnp.asarray(imgs), jnp.asarray(labels), jnp.asarray(mask), lr)
    return ts.params, float(loss)


def _port_step(make_step, model, args, batch, lr, **kw):
    opt = make_optimizer(args, model)
    step = make_step(model, opt, args, MEAN, STD, None, "cpu", **kw)
    return float(step(torch.Generator().manual_seed(0), *batch, lr))


def _assert_updates_close(model, start, ref_params, rtol, what, loose=None):
    """Every updated parameter within ``rtol`` of the largest update of
    the reference, leaf by leaf (``loose`` maps a parameter name to its own
    ``rtol``); and the update not zero."""
    got = from_jax_tree(to_jax_tree(model)[0], {})
    ref = from_jax_tree(jax.tree.map(np.asarray, ref_params), {})
    s0 = from_jax_tree(to_jax_tree(start)[0], {})
    biggest = max(float((ref[n] - s0[n]).abs().max()) for n in ref)
    assert biggest > 0
    for n in ref:
        tol = (loose or {}).get(n, rtol) * biggest
        np.testing.assert_allclose(got[n].numpy(), ref[n].numpy(), rtol=0, atol=tol,
                                   err_msg=f"{what}: {n}")


@pytest.mark.parametrize("K", [1, 4])
def test_microbatched_step_matches_jax(monkeypatch, K):
    """sigma = 0, f32, a clip (1e-3) below every example's gradient norm,
    a padded row, microbatch 4 of 6 examples (a padded chunk); K = 4 views
    of each example from explicit draws. The loss within 1e-5 relative,
    every parameter within 1e-4 of the largest update."""
    _use_views(monkeypatch, _views(K))
    batch, lr = _batch(), LR
    start = _model()
    ref, ref_loss = _jax_step(jdp.build_dp_train_step, start, _args(JaxArguments, K), batch,
                              lr, microbatch=4)
    model = copy.deepcopy(start)
    loss = _port_step(dp.build_dp_train_step, model, _args(Arguments, K), batch, lr,
                      microbatch=4)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    _assert_updates_close(model, start, ref, 1e-4, f"K={K}")


@pytest.mark.parametrize("norm,res", [("group", 32), ("batch", 32), ("group", 64)])
def test_ghost_step_matches_jax_and_the_microbatched_step(monkeypatch, norm, res):
    """At 32 px every conv takes the T^2 gram form (T <= 256); at 64 px the
    stem (T = 1024) does not. Against the JAX ghost step: the loss within
    1e-5 relative, every parameter within 1e-4 of the largest update. At
    64 px the JAX package computes the stem's per-example gradients G in
    its space-to-depth form and rounds them and the clip factors to
    bfloat16 before the clipped sum (ADVICE.md); the port keeps both in
    float32: that deviation needs 2^-8 (bfloat16's precision) of the
    largest update on the stem's weights. Against the port's microbatched step from the same
    views: within 1e-5."""
    _use_views(monkeypatch, _views(1, res=res))
    batch, lr = _batch(res=res), LR
    start = _model(norm=norm, res=res)
    ref, ref_loss = _jax_step(jdp.build_ghost_dp_train_step, start,
                              _args(JaxArguments, res=res), batch, lr, norm=norm)
    ghost = copy.deepcopy(start)
    loss = _port_step(dp.build_ghost_dp_train_step, ghost, _args(Arguments, res=res), batch, lr)
    assert loss == pytest.approx(ref_loss, rel=1e-5)
    loose = {"conv1.weight": 2.0 ** -8} if res > 32 else None
    _assert_updates_close(ghost, start, ref, 1e-4, f"ghost {norm}", loose)

    micro = copy.deepcopy(start)
    _port_step(dp.build_dp_train_step, micro, _args(Arguments, res=res), batch, lr)
    _assert_updates_close(ghost, start, to_jax_tree(micro)[0], 1e-5, f"micro {norm}")


@pytest.mark.parametrize("norm", ["group", "batch"])
def test_ghost_per_tap_form_matches_the_microbatched_step(monkeypatch, norm):
    """``GHOST_GRAM_MAX_T`` lowered to 1: every conv, the stem included,
    takes the per-tap form (G kept for sweep 2). Against the microbatched
    step: every parameter within 1e-5 of the largest update."""
    _use_views(monkeypatch, _views(1))
    monkeypatch.setattr(dp, "GHOST_GRAM_MAX_T", 1)
    batch, lr = _batch(), LR
    start = _model(norm=norm)
    ghost, micro = copy.deepcopy(start), copy.deepcopy(start)
    _port_step(dp.build_ghost_dp_train_step, ghost, _args(Arguments), batch, lr)
    _port_step(dp.build_dp_train_step, micro, _args(Arguments), batch, lr)
    _assert_updates_close(ghost, start, to_jax_tree(micro)[0], 1e-5, f"per-tap {norm}")


def test_microbatch_size_and_selection(monkeypatch):
    """The clipped sum does not depend on the microbatch (1, 4, 6 of 6
    examples: within 1e-5 of the largest update); ``select_train_step``
    picks the plain step without DP, the microbatched one for K > 1 or
    under ``PRIMIA_DP_GHOST=0``, else the ghost one."""
    _use_views(monkeypatch, _views(1))
    batch, start = _batch(), _model()
    ref = copy.deepcopy(start)
    _port_step(dp.build_dp_train_step, ref, _args(Arguments), batch, LR, microbatch=6)
    for mb in (1, 4):
        m = copy.deepcopy(start)
        _port_step(dp.build_dp_train_step, m, _args(Arguments), batch, LR, microbatch=mb)
        _assert_updates_close(m, start, to_jax_tree(ref)[0], 1e-5, f"microbatch {mb}")

    picked = []
    for name in ("build_train_step", "build_dp_train_step", "build_ghost_dp_train_step"):
        monkeypatch.setattr(dp, name, lambda *a, name=name: picked.append(name))
    args = _args(Arguments)
    for dp_on, K, ghost in ((False, 4, "1"), (True, 4, "1"), (True, 1, "0"), (True, 1, "1")):
        args.differentially_private, args.augment_multiplicity = dp_on, K
        monkeypatch.setenv("PRIMIA_DP_GHOST", ghost)
        dp.select_train_step(start, None, args, MEAN, STD)
    assert picked == ["build_train_step", "build_dp_train_step", "build_dp_train_step",
                      "build_ghost_dp_train_step"]


# --------------------------------------------------------------- the noise

@pytest.mark.parametrize("ghost", [False, True])
def test_noise_is_gaussian_at_sigma_over_the_batch(monkeypatch, ghost):
    """One step from a fresh SGD (weight decay 0): the update at sigma = 2
    minus the update at sigma = 0, times denom / (lr sigma clip), is
    N(0, 1): its mean within 4 standard errors of 0 and its standard
    deviation within 4 of 1 over the model's values (denom 5 of 6 rows,
    one padded)."""
    _use_views(monkeypatch, _views(1))
    batch, lr, clip, sigma = _batch(), 0.5, 1e-3, 2.0
    make_step = dp.build_ghost_dp_train_step if ghost else dp.build_dp_train_step
    start = _model()
    quiet, noisy = copy.deepcopy(start), copy.deepcopy(start)
    _port_step(make_step, quiet, _args(Arguments, clip=clip), batch, lr)
    _port_step(make_step, noisy, _args(Arguments, clip=clip, sigma=sigma), batch, lr)
    z = torch.cat([(a - b).detach().reshape(-1) for a, b in
                   zip(quiet.parameters(), noisy.parameters())]).double()
    z *= batch[2].sum() / (lr * sigma * clip)
    n = z.numel()
    assert abs(float(z.mean())) < 4 / n ** 0.5
    assert abs(float(z.std()) - 1.0) < 4 / (2 * n) ** 0.5


def test_noise_differs_between_steps_and_nodes_and_ignores_secure_noise(monkeypatch):
    """Two steps of one generator draw different noise, two generators
    (two nodes) too; ``PRIMIA_DP_SECURE_NOISE=1`` draws the same as unset,
    and says so."""
    params = list(_model().parameters())

    def draw(gen):
        acc = dp.FlatGrads(params, "cpu")
        acc.noise_and_average(gen, 1.0, torch.ones(1))
        return acc.flat

    g = torch.Generator().manual_seed(7)
    first, second = draw(g), draw(g)
    other = draw(torch.Generator().manual_seed(8))
    assert not torch.equal(first, second) and not torch.equal(first, other)
    unset = draw(torch.Generator().manual_seed(7))
    monkeypatch.setenv("PRIMIA_DP_SECURE_NOISE", "1")
    args = _args(Arguments, sigma=1.0)
    with pytest.warns(RuntimeWarning, match="PRIMIA_DP_SECURE_NOISE"):
        dp.build_ghost_dp_train_step(_model(), make_optimizer(args, _model()), args, MEAN,
                                     STD, None, "cpu")
    assert torch.equal(draw(torch.Generator().manual_seed(7)), unset)


# ------------------------------------------------------ the split group norm

def test_split_group_norm_is_bit_equal_and_matches_jax():
    """``group_normalize`` then the affine equals the former one-piece
    ``group_norm`` bit for bit (float32 and bfloat16), and JAX's
    ``group_norm`` within 1e-5."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0.3, 2.0, (3, 64, 5, 6)).astype(np.float32))
    g = torch.from_numpy(rng.uniform(0.5, 1.5, 64).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.2, 64).astype(np.float32))

    def one_piece(x, gamma, beta, groups=32, eps=1e-5):
        B, C = x.shape[:2]
        G = min(groups, C)
        xf = x.float().reshape(B, G, -1)
        mean = xf.mean(-1, keepdim=True)
        var = (xf.square().mean(-1, keepdim=True) - mean.square()).clamp(min=0.0)
        xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape).to(x.dtype)
        return xhat * _channel(gamma) + _channel(beta)

    for dt in (torch.float32, torch.bfloat16):
        xs, gs, bs = x.to(dt), g.to(dt), b.to(dt)
        assert torch.equal(group_norm(xs, gs, bs), one_piece(xs, gs, bs))
        assert torch.equal(group_normalize(xs) * _channel(gs) + _channel(bs),
                           group_norm(xs, gs, bs))
    ref = jax_group_norm(PLAIN, jnp.asarray(x.permute(0, 2, 3, 1).numpy()),
                         {"gamma": jnp.asarray(g.numpy()), "beta": jnp.asarray(b.numpy())})
    np.testing.assert_allclose(group_norm(x, g, b).permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), atol=1e-5)


# ------------------------------------------------------------ K7 under vmap

def test_microbatched_step_refuses_k7_under_vmap(monkeypatch):
    """K7 under ``torch.func.vmap`` (this step refused it until its Function
    had a vmap rule). Per-example weight gradients through
    ``conv3x3_s1p1`` under ``vmap(grad(...))``, with each example's K = 4
    views as its batch, equal ``torch.func``'s gradients of ``F.conv2d``
    (every operand a multiple of 1/4, so every sum is exact), with one K7
    call an example at that example's shapes; the data gradient too. Then
    the microbatched step with K = 4, bfloat16 compute and
    ``PRIMIA_PALLAS_WGRAD=1`` builds and runs, calls K7 for layer2's and
    layer3's stride-1 convs, and its update at sigma = 0 is within 2e-2 of
    the unswitched step's largest (bfloat16 rounding of the two weight
    gradients apart)."""
    from torch.func import grad, vmap

    from primia_tpu_torch.ops import cuda_wgrad

    calls = []
    k7 = cuda_wgrad.conv3x3_wgrad

    def counted(x, g):
        calls.append((tuple(x.shape), tuple(g.shape)))
        return k7(x, g)

    monkeypatch.setattr(cuda_wgrad, "conv3x3_wgrad", counted)
    rng = np.random.default_rng(7)
    n, K, ci, co, H = 3, 4, 8, 16, 5
    x, t = (torch.from_numpy(np.round(rng.normal(0, 4, s)) / 4).float()
            for s in ((n, K, ci, H, H), (n, K, co, H, H)))
    w = torch.from_numpy(np.round(rng.normal(0, 4, (co, ci, 3, 3))) / 4).float()

    def loss(conv, w, x, t):
        return (conv(x, w) * t).sum()

    k7_loss = partial(loss, cuda_wgrad.conv3x3_s1p1)
    ref_loss = partial(loss, lambda x, w: torch.nn.functional.conv2d(x, w, padding=1))
    for argnums in (0, 1):
        got = vmap(grad(k7_loss, argnums), in_dims=(None, 0, 0))(w, x, t)
        want = vmap(grad(ref_loss, argnums), in_dims=(None, 0, 0))(w, x, t)
        assert torch.equal(got, want)
    assert calls == [((K, ci, H, H), (K, co, H, H))] * n  # the weight gradient's pass only

    monkeypatch.setenv("PRIMIA_PALLAS_WGRAD", "1")
    _use_views(monkeypatch, _views(4))
    batch, lr = _batch(), LR
    start = _model()
    args = _args(Arguments, K=4)
    args.compute_dtype = "bfloat16"
    calls.clear()
    switched = copy.deepcopy(start)
    _port_step(dp.build_dp_train_step, switched, args, batch, lr, microbatch=4)
    # 5 real examples and a padded one in 2 chunks of 4: 8 examples a conv
    assert len(calls) == 2 * 8 and {c[0][0] for c in calls} == {4}
    monkeypatch.delenv("PRIMIA_PALLAS_WGRAD")
    default = copy.deepcopy(start)
    _port_step(dp.build_dp_train_step, default, args, batch, lr, microbatch=4)
    _assert_updates_close(switched, start, to_jax_tree(default)[0], 2e-2, "switched K7")


# ------------------------------------------------------------------- CLIs

def _dp_ini(tmp_path, base, replacements, name="dp.ini"):
    text = base.read_text()
    for old, new in replacements:
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / name
    ini.write_text(text)
    return ini


# the DP INI cut to the fixture: 32 px, batch 4, one epoch evaluated, the
# augmentation off (its draws differ between the packages), sigma = 0
LOCAL = [("batch_size = 512", "batch_size = 4"),
         ("train_resolution = 224", "train_resolution = 32"), ("epochs = 60", "epochs = 1"),
         ("test_interval = 2", "test_interval = 1"), ("rotation = 10", "rotation = 0"),
         ("scale = 0.1", "scale = 0"), ("overall_prob = 0.75", "overall_prob = 0"),
         ("noise_multiplier = 2.0", "noise_multiplier = 0.0")]


def _shared_checkpoint(path, args, seed=5):
    """The port's initial model (He init, the zero fc of the group-norm
    variant replaced by a small random one, so every layer trains from the
    first step) with a fresh SGD state, as both CLIs resume it."""
    from primia_tpu_torch.nn import create_model

    torch.manual_seed(seed)
    model = create_model(args, num_classes=3, device="cpu")
    torch.nn.init.normal_(model.fc.weight, std=0.05)
    ckpt.save_model(path, epoch=0, model=model, args=args,
                    val_mean_std=(np.zeros(3), np.ones(3)),
                    opt_state=make_optimizer(args, model).state_to_jax())
    return path


def _eps_lines(text):
    return [line for line in text.splitlines() if line.startswith("(eps = ")]


def test_dp_cli_matches_jax_from_a_shared_checkpoint_and_resumes_raw(tmp_path, fixture_dir,
                                                                    monkeypatch, capsys):
    """``pneumonia-resnet-dp.ini`` (ResNet-18, group norm, SGD with momentum,
    K = 4, EMA 0.99) cut to the fixture at sigma = 0 through both train
    CLIs from one shared checkpoint (3 steps): the saved EMA parameters and
    the SGD momentum within 1e-4 of their largest value; the epsilon lines
    equal; the port's checkpoint, which also holds the raw parameters,
    scored to the same stats table by both evaluate CLIs. Then a resume of
    that checkpoint with sigma = 2 for epoch 2: the step starts from the raw
    parameters and momentum, the EMA from the saved average, and the
    epsilon line is the accountant's for 6 steps at q = 4 / 12."""
    from primia_tpu.cli.evaluate import main as jax_evaluate
    from primia_tpu.cli.train import main as jax_train
    from primia_tpu_torch.cli.evaluate import main as port_evaluate
    from primia_tpu_torch.cli.train import main as port_train
    from primia_tpu_torch.train import loop

    ini = _dp_ini(tmp_path, DP_INI, LOCAL)
    shared = _shared_checkpoint(tmp_path / "shared.pt", Arguments.from_ini(ini))
    argv = ["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
            "--resume_checkpoint", str(shared)]
    finals, out = {}, {}
    for name, train, extra in (("jax", jax_train, []), ("port", port_train, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        with pytest.warns(UserWarning, match="pretrained"):
            train(argv + extra)
        out[name] = capsys.readouterr().out
        found = sorted((tmp_path / name / "model_weights").glob("final_*.pt"))
        assert len(found) == 1
        finals[name] = found[0]
    assert _eps_lines(out["port"]) == _eps_lines(out["jax"]) == [
        "(eps = inf, delta = 1e-05) at alpha = None"]

    got, ref = (jax_ckpt.load_model(finals[k]) for k in ("port", "jax"))
    assert got["epoch"] == ref["epoch"] == 1
    assert int(got["optim_state_dict"].step) == int(ref["optim_state_dict"].step) == 3
    start = jax_ckpt.load_model(shared)["model_state_dict"]["params"]
    pairs = list(zip(jax.tree.leaves(got["model_state_dict"]["params"]),
                     jax.tree.leaves(ref["model_state_dict"]["params"])))
    pairs.append((got["optim_state_dict"].momentum, ref["optim_state_dict"].momentum))
    for a, b in pairs:
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-4 * np.abs(b).max())
    # the raw parameters moved; their average over 3 steps at decay 0.99
    # (1% of each step's parameters) moved a few percent as far
    raw = jax.tree.leaves(got["raw_params"])
    ema = jax.tree.leaves(got["model_state_dict"]["params"])
    moved, ema_moved = (max(float(np.abs(p - s).max()) for p, s in
                            zip(t, jax.tree.leaves(start))) for t in (raw, ema))
    assert 0 < ema_moved < 0.1 * moved

    argv_eval = ["--data_dir", str(fixture_dir / "test"), "--model_weights",
                 str(finals["port"])]
    with pytest.warns(UserWarning, match="pretrained"):
        jax_stats = jax_evaluate(argv_eval)
    jax_table = capsys.readouterr().out
    port_stats = port_evaluate(argv_eval + ["--device", "cpu"])
    port_table = capsys.readouterr().out
    np.testing.assert_array_equal(port_stats["conf_matrix"], jax_stats["conf_matrix"])
    table = [line for line in port_table.splitlines() if "│" in line]
    assert table and table == [line for line in jax_table.splitlines() if "│" in line]

    # resume: the raw trajectory and its momentum, the EMA from the average
    seen = {}
    select = loop.select_train_step

    def spy(model, optimizer, *a):
        seen["params"] = to_jax_tree(model)[0]
        seen["momentum"] = optimizer.state_to_jax().momentum
        return select(model, optimizer, *a)

    monkeypatch.setattr(loop, "select_train_step", spy)
    build_eval = loop.build_eval_step

    def eval_spy(model, *a):
        seen["evaluated"] = to_jax_tree(model)[0]
        return build_eval(model, *a)

    monkeypatch.setattr(loop, "build_eval_step", eval_spy)
    ini2 = _dp_ini(tmp_path, ini, [("epochs = 1", "epochs = 2"),
                                   ("noise_multiplier = 0.0", "noise_multiplier = 2.0")],
                   name="resume.ini")
    monkeypatch.chdir(tmp_path / "port")
    for f in (tmp_path / "port" / "model_weights").glob("final_*.pt"):
        f.rename(tmp_path / "first.pt")
    port_train(["--config", str(ini2), "--data_dir", str(fixture_dir / "train"),
                "--resume_checkpoint", str(tmp_path / "first.pt"), "--device", "cpu"])
    resumed_out = capsys.readouterr().out
    for a, b in zip(jax.tree.leaves(seen["params"]), raw):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(seen["momentum"], got["optim_state_dict"].momentum)
    for a, b in zip(jax.tree.leaves(seen["evaluated"]), ema):
        np.testing.assert_array_equal(a, b)
    eps, alpha = jdp.rdp_epsilon(noise_multiplier=2.0, sample_rate=4 / 12, steps=6,
                                 delta=1e-5)
    assert _eps_lines(resumed_out) == [f"(eps = {eps:.2f}, delta = 1e-05) at alpha = {alpha}"]
    second = jax_ckpt.load_model(sorted((tmp_path / "port" / "model_weights").glob(
        "final_*.pt"))[0])
    assert second["epoch"] == 2 and int(second["optim_state_dict"].step) == 6


def _fed_shards(root: Path, per_class=(4, 3, 2), validation=3, seed=1):
    """worker1..3 with 4/3/2 images a class and a validation folder: 32x32
    full-range noise a class brighter (``tests/test_torch_federated.py``'s
    parity images)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    classes = ("bacterial pneumonia", "normal", "viral pneumonia")
    folders = [(f"worker{w + 1}", n) for w, n in enumerate(per_class)] + [("validation",
                                                                           validation)]
    for folder, n in folders:
        for ci, cls in enumerate(classes):
            d = root / folder / cls
            d.mkdir(parents=True)
            for i in range(n):
                img = (rng.integers(0, 256, (32, 32)) // 2 + 40 * ci).astype(np.uint8)
                Image.fromarray(img, mode="L").save(d / f"{i}.jpeg")
    return root


def _fed_ini(tmp_path, K, sigma=0.0, res=64):
    """The federated DP INI at ``res`` px, batch 3, one epoch evaluated,
    augmentation off, multiplicity ``K``."""
    return _dp_ini(tmp_path, DP_FED_INI, [
        ("batch_size = 512", "batch_size = 3"),
        ("train_resolution = 224", f"train_resolution = {res}"),
        ("epochs = 60", "epochs = 1"), ("test_interval = 2", "test_interval = 1"),
        ("rotation = 10", "rotation = 0"), ("scale = 0.1", "scale = 0"),
        ("overall_prob = 0.75", "overall_prob = 0"),
        ("noise_multiplier = 3.0", f"noise_multiplier = {sigma}"),
        ("augment_multiplicity = 4", f"augment_multiplicity = {K}")], name="fed_dp.ini")


STEP = 2.0 ** -16  # one fixed-point step of the secure aggregation


def _small_models(monkeypatch):
    """Both packages' federated loops build ResNet (1, 1, 1, 1) with group
    norm, as ``_model`` does, in place of ResNet-18: the JAX side compiles
    its node-vmapped DP step in a fraction of the time."""
    import primia_tpu.parallel.federated as jax_fed
    import primia_tpu_torch.parallel.federated as port_fed
    from primia_tpu.nn.resnet import resnet_init

    def jax_create(args, num_classes=None, dtype=jnp.float32):
        md = _jax_model_def("group", args.inference_resolution)
        init = partial(resnet_init, layers=list(LAYERS), num_classes=num_classes,
                       zero_init_fc=True)
        return ModelDef(md.name, init, md.forward, md.input_size, 3, num_classes, md.pooling)

    def port_create(args, num_classes=None, device="cuda"):
        return _model(res=args.inference_resolution).to(
            device=device, memory_format=torch.channels_last).eval()

    monkeypatch.setattr(jax_fed, "create_model", jax_create)
    monkeypatch.setattr(port_fed, "create_model", port_create)
    return port_create


@pytest.mark.parametrize("path", ["ghost", "microbatched"])
def test_federated_dp_cli_matches_jax_from_a_shared_checkpoint(tmp_path, monkeypatch, capsys,
                                                               path):
    """``pneumonia-resnet-dp-federated.ini`` (per-node DP-SGD, secure
    aggregation after every step, SGD momentum kept across syncs, EMA 0.99
    across aggregation rounds) at 64 px, batch 3, sigma = 0, on ResNet
    (1, 1, 1, 1) with group norm, through both train CLIs from one shared
    checkpoint, on shards of 6 images a node: 2 federated steps, 2
    aggregations (the EMA starts at the first and takes the second).
    ``ghost``: K = 1, the ghost-norm step; ``microbatched``: the INI's
    K = 4. A node's two steps both come before the first aggregation, so
    its trajectory is compared before the aggregation's rounding feeds
    back into a gradient. Limits: the saved EMA parameters within 8
    fixed-point steps (8 x 2^-16, as ``tests/test_torch_federated.py``
    holds a federated run); each worker's kept SGD momentum within 1e-4
    of its largest value; the per-node epsilon lines equal. On the ghost
    path the JAX package's 64 px stem rounds its per-example G and the
    clip factors to bfloat16 (ADVICE.md), the port keeps them in float32:
    the stem's weights may differ by 2^-8 of their movement more, and the
    second step's gradients, taken at those weights, move the momentum by
    a few percent; so there the port's momentum is held within 1e-4 to the
    port's own microbatched run (``PRIMIA_DP_GHOST=0``) instead."""
    from primia_tpu.cli.train import main as jax_train
    from primia_tpu_torch.cli.train import main as port_train

    port_create = _small_models(monkeypatch)
    data = _fed_shards(tmp_path / "data", per_class=(2, 2, 2))
    ini = _fed_ini(tmp_path, K=1 if path == "ghost" else 4)
    args = Arguments.from_ini(ini)
    model = port_create(args, 3, "cpu")
    torch.nn.init.normal_(model.fc.weight, std=0.05)
    shared = tmp_path / "shared.pt"
    ckpt.save_model(shared, epoch=0, model=model, args=args,
                    val_mean_std=(np.zeros(3), np.ones(3)))
    argv = ["--config", str(ini), "--data_dir", str(data), "--train_federated",
            "--resume_checkpoint", str(shared)]
    finals, out = {}, {}
    runs = [("jax", jax_train, []), ("port", port_train, ["--device", "cpu"])]
    if path == "ghost":
        runs.append(("port_microbatched", port_train, ["--device", "cpu"]))
    for name, train, extra in runs:
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        if name == "port_microbatched":
            monkeypatch.setenv("PRIMIA_DP_GHOST", "0")
        train(argv + extra)
        out[name] = capsys.readouterr().out
        found = sorted((tmp_path / name / "model_weights").glob("final_federated_*.pt"))
        assert len(found) == 1
        finals[name] = found[0]
    lines = _eps_lines(out["port"])
    assert lines == _eps_lines(out["jax"]) and len(lines) == 1
    assert lines[0].startswith("(eps = inf, delta = 1e-05) at alpha = None [worst node: worker1")

    got, ref = (jax_ckpt.load_model(finals[k]) for k in ("port", "jax"))
    assert got["epoch"] == ref["epoch"] == 1 and "raw_params" in got
    start = from_jax_tree(jax_ckpt.load_model(shared)["model_state_dict"]["params"], {})
    a, b = (from_jax_tree(t["model_state_dict"]["params"], {}) for t in (got, ref))
    moved = max(float((b[n] - start[n]).abs().max()) for n in b)
    assert moved > 16 * STEP
    for n in b:
        tol = 8 * STEP
        if path == "ghost" and n == "conv1.weight":
            tol += 2.0 ** -8 * float((b[n] - start[n]).abs().max())
        np.testing.assert_allclose(a[n].double().numpy(), b[n].double().numpy(), rtol=0,
                                   atol=tol, err_msg=n)
    steps = {w: int(got["optim_state_dict"][w].step) for w in got["optim_state_dict"]}
    assert steps == {w: int(ref["optim_state_dict"][w].step) for w in steps} == {
        "worker1": 2, "worker2": 2, "worker3": 2}
    held = jax_ckpt.load_model(finals["port_microbatched"]) if path == "ghost" else ref
    for w in steps:
        a, b = (np.asarray(t["optim_state_dict"][w].momentum) for t in (got, held))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max(), err_msg=w)


@pytest.mark.parametrize("K", [1, 4])
def test_each_federated_node_steps_as_a_node_alone(tmp_path, monkeypatch, K):
    """At sigma = 3, with the augmentation on: a federated step of nodes 0
    and 1 (node 2 sits out) leaves each node's parameters bit-equal to one
    model stepped alone with its own DP step and the node's generator
    (seed, 99, node), so each node draws its own noise and augmentation;
    node 2 is unchanged. K = 1 is the ghost-norm step, K = 4 the
    microbatched one."""
    from primia_tpu_torch.data import Batch
    from primia_tpu_torch.mpc import shares as S
    from primia_tpu_torch.parallel.federated import FederatedNodes

    monkeypatch.chdir(tmp_path)
    args = Arguments.from_ini(_fed_ini(tmp_path, K=K, sigma=3.0, res=RES))
    args.train_federated = True
    model = _model()
    nodes = FederatedNodes(args, model, 3, MEAN, STD, None, "cpu")
    start = copy.deepcopy(model)
    batches = [Batch(*_batch(B=3, seed=10 + i)) for i in range(2)] + [None]
    nodes.step(batches, 0.5)
    for i, b in enumerate(batches):
        alone = copy.deepcopy(start)
        if b is not None:
            step = dp.select_train_step(alone, make_optimizer(args, alone), args, MEAN, STD,
                                        None, "cpu")
            step(S.stream("cpu", args.seed, 99, i), b.images, b.labels, b.mask, 0.5)
        for (n, p), q in zip(nodes.models[i].named_parameters(), alone.parameters()):
            assert torch.equal(p, q), (i, n)
    assert not torch.equal(nodes.models[0].fc.weight, nodes.models[1].fc.weight)
