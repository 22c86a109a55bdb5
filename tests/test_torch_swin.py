"""Swin-B (``nn/swin.py``) on the CPU: the port against the benchmark's plain
reference (``benchmark/reference/families/swin.py``), which the JAX package
has no counterpart of, on seeded weights (``benchmark.common.make_weights``);
its parts against brute-force forms; its train step, CLI and checkpoint; the
paths that refuse it, and MaxViT-B (``nn/maxvit.py``), which holds the same
window attention.

At 96 px the window is 3 and the stages' maps are 24², 12², 6² and 3²
tokens, so the first three stages shift their odd blocks (by one token) and
the last attends over its whole map. The widths are Swin-B's, or, where a
test only needs the mechanism, a narrow Swin of the same layout (embedding
32, heads 1-2-4-8, depths 2-2-2-2, head dim 32).
"""

import itertools
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import common
from benchmark.reference import models as ref_models
from benchmark.reference.families import swin as ref_swin
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import create_model, swin
from primia_tpu_torch.nn.core import Norm, group_norm
from primia_tpu_torch.nn.jax_params import from_jax_tree, param_leaves
from primia_tpu_torch.ops import cuda_attention, cuda_swin_norm
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.optim import make_optimizer
from primia_tpu_torch.train.steps import build_train_step

NARROW = {"embed_dim": 32, "depths": (2, 2, 2, 2), "num_heads": (1, 2, 4, 8)}
RES = 96


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arch(widths, res=RES):
    return {"family": "swin", "resolution": res, "in_channels": 3, "num_classes": 3,
            "norm": "layer", "patch_size": 4, "mlp_ratio": 4, "embed_dim": widths["embed_dim"],
            "depths": list(widths["depths"]), "num_heads": list(widths["num_heads"])}


def _seeded(widths, seed=3, res=RES):
    """A Swin of ``widths`` with the benchmark's seeded weights, and them."""
    model = swin.SwinTransformer(num_classes=3, in_channels=3, input_size=res, **widths)
    W, B = common.make_weights(torch.Generator().manual_seed(seed), model)
    common.load_into(model, W, B)
    return model, W, B


def _images(n, seed=4, res=RES):
    return torch.randn(n, 3, res, res, generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------------ norms

def test_layer_norm_is_f_layer_norm_and_has_no_state():
    """A layer norm returns the residual stream (x itself, with no branch to
    add) and ``F.layer_norm`` of it, float32 unless asked otherwise."""
    n = Norm(24, "layer")
    with torch.no_grad():
        n.weight.normal_()
        n.bias.normal_()
    x = torch.randn(2, 5, 7, 24)
    # the same call: equal bits
    s, y = n(x)
    assert s is x and torch.equal(y, F.layer_norm(x, (24,), n.weight, n.bias, 1e-5))
    assert dict(n.named_buffers()) == {}
    assert set(dict(n.named_parameters())) == {"weight", "bias"}
    n.train()
    assert torch.equal(n(x)[1], F.layer_norm(x, (24,), n.weight, n.bias, 1e-5))


def test_batch_and_group_norm_are_unchanged():
    """The other kinds keep their buffers and their forward: train-mode batch
    norm is ``F.batch_norm`` with the running statistics moved, eval mode
    the folded affine, group norm ``group_norm`` (bit for bit: the same
    calls)."""
    x = torch.randn(4, 8, 5, 5)
    b = Norm(8, "batch")
    assert set(dict(b.named_buffers())) == {"running_mean", "running_var",
                                             "num_batches_tracked"}
    rm, rv = torch.zeros(8), torch.ones(8)
    b.train()
    assert torch.equal(b(x), F.batch_norm(x, rm, rv, b.weight, b.bias, training=True,
                                          momentum=0.1, eps=1e-5))
    assert torch.equal(b.running_mean, rm) and torch.equal(b.running_var, rv)
    assert int(b.num_batches_tracked) == 1
    g = Norm(8, "group")
    assert torch.equal(g(x), group_norm(x, g.weight, g.bias, 32, 1e-5))
    with pytest.raises(ValueError, match="unknown normalization"):
        Norm(8, "instance")


# ------------------------------------------------------------------ parts

@pytest.mark.parametrize("window", [2, 3, 7, 12])
def test_relative_index_against_a_loop_over_token_pairs(window):
    idx = swin.relative_position_index(window)
    want = torch.empty(window ** 2, window ** 2, dtype=torch.long)
    for i, j in itertools.product(range(window ** 2), repeat=2):
        (yi, xi), (yj, xj) = divmod(i, window), divmod(j, window)
        want[i, j] = (yi - yj + window - 1) * (2 * window - 1) + (xi - xj + window - 1)
    assert idx.dtype == torch.long and torch.equal(idx, want)
    assert torch.equal(ref_swin.relative_index(window), want)
    assert int(idx.max()) == (2 * window - 1) ** 2 - 1


@pytest.mark.parametrize("res,window", [(24, 3), (12, 3), (6, 3), (48, 12), (24, 12)])
def test_shift_mask_against_a_brute_force_region_labelling(res, window):
    """A pair of a window of the map rolled by (-s, -s) is masked where one
    token of it wrapped around an edge of the map and the other did not,
    along either axis: the tokens were not neighbours before the roll."""
    s = window // 2
    mask = swin.shift_mask(res, window, s)
    n_side = res // window
    assert mask.dtype == torch.bool and mask.shape == (n_side ** 2, window ** 2, window ** 2)

    def wrapped(r):  # rolled index r holds original index (r + s) % res
        return r + s >= res

    want = torch.zeros_like(mask)
    for wy, wx in itertools.product(range(n_side), repeat=2):
        toks = [(wy * window + a, wx * window + b) for a in range(window) for b in range(window)]
        for i, j in itertools.product(range(window ** 2), repeat=2):
            (yi, xi), (yj, xj) = toks[i], toks[j]
            want[wy * n_side + wx, i, j] = (wrapped(yi) != wrapped(yj)
                                            or wrapped(xi) != wrapped(xj))
    assert torch.equal(mask, want)
    assert torch.equal(ref_swin.region_mask(res, window, s), want)


def test_window_partition_and_reverse_are_inverse():
    x = torch.arange(2 * 12 * 12 * 5, dtype=torch.float32).reshape(2, 12, 12, 5)
    w = swin.window_partition(x, 3)
    assert w.shape == (2, 16, 9, 5)
    # window 5 (row 1, column 1) holds tokens (3..5) x (3..5), row-major
    assert torch.equal(w[1, 5], x[1, 3:6, 3:6].reshape(9, 5))
    assert torch.equal(cuda_swin_norm.window_reverse(w, 3, 12, 12), x)


@pytest.mark.parametrize("res,window", [(24, 3), (12, 3), (6, 3), (48, 12), (24, 12)])
def test_a_shifted_block_registers_the_region_ids_of_its_mask(res, window):
    """A shifted block keeps its windows' region ids (the kernels' input, not
    the (nW, L, L) mask); pairs whose ids differ are exactly
    :func:`shift_mask`'s, which the brute-force labelling above pins."""
    s = window // 2
    blk = swin.SwinBlock(32, 1, res, window, s)
    ids = blk.attn_regions
    assert ids.dtype == torch.int32 and ids.shape == ((res // window) ** 2, window ** 2)
    assert torch.equal(ids[:, None, :] != ids[:, :, None], swin.shift_mask(res, window, s))
    assert swin.SwinBlock(32, 1, res, window, 0).attn_regions is None


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_against_an_explicit_softmax(masked):
    """float64: the call equals softmax(q k^T / sqrt(d) + bias + mask) v
    within 1e-12 (two orders of summation of float64 sums of 9 products),
    and so do the gradients of q, k, v and the bias."""
    B, nW, h, L, d = 2, 4, 3, 9, 32
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(B, nW, h, L, d, generator=g, dtype=torch.float64, requires_grad=True)
               for _ in range(3))
    bias = torch.randn(h, L, L, generator=g, dtype=torch.float64, requires_grad=True)
    regions = swin.shift_regions(6, 3, 1) if masked else None
    out = swin.window_attention(q, k, v, bias, regions)
    logits = q @ k.transpose(-1, -2) / d ** 0.5 + bias
    if masked:
        mask = swin.shift_mask(6, 3, 1)
        logits = logits + torch.where(mask, cuda_attention.MASK_VALUE, 0.0)[None, :, None]
    want = torch.softmax(logits, -1) @ v
    torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
    up = torch.randn(out.shape, generator=g, dtype=torch.float64)
    got = torch.autograd.grad((out * up).sum(), (q, k, v, bias))
    ref = torch.autograd.grad((want * up).sum(), (q, k, v, bias))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    assert float(got[3].abs().max()) > 0


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_on_the_qkv_views_equals_contiguous_copies(masked):
    """float64: q, k, v as ``WindowAttention.forward`` passes them, strided
    (B, nW, h, L, d) views of one (B, nW, L, 3C) qkv output, give the call
    on contiguous copies bit for bit (the same plain arithmetic), forward and
    the gradients of the qkv output (through the views) and the bias."""
    B, nW, h, L, d = 2, 4, 3, 9, 32
    g = torch.Generator().manual_seed(6)
    qkv = torch.randn(B, nW, L, 3 * h * d, generator=g, dtype=torch.float64, requires_grad=True)
    bias = torch.randn(h, L, L, generator=g, dtype=torch.float64, requires_grad=True)
    regions = swin.shift_regions(6, 3, 1) if masked else None
    views = [t.transpose(2, 3) for t in qkv.reshape(B, nW, L, 3, h, d).unbind(3)]
    assert not any(t.is_contiguous() for t in views)
    copies = [t.contiguous() for t in views]
    out = swin.window_attention(*views, bias, regions)
    want = swin.window_attention(*copies, bias, regions)
    assert torch.equal(out, want)
    up = torch.randn(out.shape, generator=g, dtype=torch.float64)
    *got, dqkv = torch.autograd.grad((out * up).sum(), (*views, bias, qkv))
    ref = torch.autograd.grad((want * up).sum(), (*copies, bias))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert torch.equal(dqkv.reshape(B, nW, L, 3, h, d), torch.stack([t.transpose(2, 3)
                                                                    for t in got[:3]], 3))


@pytest.mark.parametrize("what,shape,bias_shape,regions_shape,match", [
    ("d", (1, 2, 2, 9, 16), (2, 9, 9), None, "head dim 32"),
    ("L", (1, 1, 2, 169, 32), (2, 169, 169), None, "at most 144 tokens"),
    ("bias", (1, 2, 2, 9, 32), (2, 9, 8), None, r"bias must be \(2, 9, 9\)"),
    ("bias heads", (1, 2, 2, 9, 32), (3, 9, 9), None, r"bias must be \(2, 9, 9\)"),
    ("regions", (1, 2, 2, 9, 32), (2, 9, 9), (2, 8), r"region ids must be \(2, 9\)"),
])
def test_window_attention_refuses_what_the_kernels_do_not_take(what, shape, bias_shape,
                                                               regions_shape, match):
    """The wrapper's checks hold on every device, the CPU's plain version
    included: head dim 32, at most 144 tokens a window, an (h, L, L) bias,
    (nW, L) integer region ids."""
    q = torch.zeros(shape)
    regions = None if regions_shape is None else torch.zeros(regions_shape, dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        swin.window_attention(q, q, q, torch.zeros(bias_shape), regions)


def test_the_attention_counter_counts_under_a_profiler_only():
    from primia_tpu_torch import utils

    model, _, _ = _seeded(NARROW)
    before = utils.counters["attention_calls"]
    model(_images(1))
    assert utils.counters["attention_calls"] == before
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        model(_images(1))
    assert utils.counters["attention_calls"] == before + sum(NARROW["depths"])


def test_window_and_shift_follow_the_resolution():
    """Window input // 32; shifted odd blocks in stages whose map is larger
    than the window; the last stage one unshifted window. At 384 px the
    published window 12 and shift 6."""
    m = swin.SwinTransformer(input_size=384)
    got = [[(b.window, b.shift) for b in s.blocks] for s in m.layers]
    assert got == [[(12, 0), (12, 6)]] * 2 + [[(12, 0), (12, 6)] * 9] + [[(12, 0), (12, 0)]]
    assert sum(p.numel() for p in m.parameters()) == 86_881_659
    assert m.layers[0].blocks[0].attn.relative_position_bias_table.shape == (529, 4)
    assert m.layers[3].blocks[0].attn.relative_position_bias_table.shape == (529, 32)
    with pytest.raises(ValueError, match="multiple of 32"):
        swin.SwinTransformer(input_size=100)
    with pytest.raises(ValueError, match="built for 96 px"):
        _seeded(NARROW)[0](_images(1, res=128))


# ------------------------------------------------------- against the reference

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_match_the_reference(train):
    """Swin-B's widths at 96 px, float32: the logits within 1e-5 of the
    largest (the port's fused SDPA and the reference's explicit softmax sum
    in other orders; float32 keeps about 7 digits)."""
    model, W, B = _seeded(swin.SWIN_B)
    x = _images(2)
    model.train(train)
    with torch.no_grad():
        got = model(x)
        taps = {}
        want = ref_models.forward(W, B, x, _arch(swin.SWIN_B), train, taps=taps)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert taps["head_input"].shape == (2, 1024)


def test_every_leaf_gradient_matches_the_reference():
    """Swin-B's widths at 96 px, float32, train mode (the reference's blocks
    under checkpointing): every leaf's gradient, the relative-position bias
    tables' included, within 1e-4 of its largest value (float32 rounding
    through 24 blocks and their recomputation)."""
    model, W, B = _seeded(swin.SWIN_B)
    x = _images(2)
    y = F.one_hot(torch.tensor([0, 2]), 3).float()
    model.train()
    names = [n for n, _ in param_leaves(model)]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    params = dict(model.named_parameters())
    loss = -(y * F.log_softmax(model(x), 1)).sum(1).mean()
    got = torch.autograd.grad(loss, [params[n] for n in names])
    P = {n: W[n].clone().requires_grad_(True) for n in names}
    rloss = -(y * F.log_softmax(ref_models.forward(P, B, x, _arch(swin.SWIN_B), True), 1)
              ).sum(1).mean()
    want = torch.autograd.grad(rloss, [P[n] for n in names])
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=0)
    tables = 0
    for n, a, b in zip(names, got, want):
        scale = float(b.abs().max())
        assert scale > 0, n
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale, msg=n)
        tables += n.endswith("relative_position_bias_table")
    assert tables == 24


# ------------------------------------------------------- the port's paths

def _args(**kw):
    return Arguments(model="swin-b", batch_size=2, train_resolution=RES,
                     inference_resolution=RES, lr=1e-3, beta1=0.5, beta2=0.99,
                     weight_decay=5e-4, mixup=True, mixup_prob=0.9, **kw)


def test_create_model_builds_swin_b():
    with pytest.warns(UserWarning, match="pretrained"):
        m = create_model(_args(pretrained=True), num_classes=3, device="cpu")
    assert isinstance(m, swin.SwinTransformer) and not m.training
    assert (m.in_channels, m.num_classes, m.input_size, m.pooling, m.window) == (3, 3, RES,
                                                                                  "avg", 3)
    assert m.patch_embed.proj.weight.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="normalization=group"):
        create_model(_args(normalization="group"), device="cpu")
    with pytest.raises(ValueError, match="Unknown model"):
        Arguments(model="swin-l")


def test_one_train_step_moves_every_leaf():
    """One step through ``build_train_step`` with the recipe's augmentation,
    MixUp and Adam: a finite loss, and every leaf, each bias table included,
    moved (Adam's first step moves each leaf with a gradient by about lr)."""
    args = _args(pretrained=True, clahe=True, randomgamma=True, blur=True, elastic=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = create_model(args, num_classes=3, device="cpu")
    opt = make_optimizer(args, model)
    assert len(opt.params) == len(list(model.parameters())) == 329
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    imgs, labels = common.make_images(torch.Generator().manual_seed(6), 2, RES)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, opt, args, mean, std, device="cpu")
    loss = step(torch.Generator().manual_seed(7), imgs, labels.numpy(), np.ones(2, np.float32),
                args.lr)
    assert torch.isfinite(loss)
    for n, p in model.named_parameters():
        assert not torch.equal(p, before[n]), n


def test_a_checkpoint_reloads_to_identical_logits(tmp_path, fixture_dir):
    """``train/checkpoint.py`` writes the model (the bias tables under
    ``bias_table``, no state for layer norms); a fresh model loads it
    strictly and gives the same logits; the evaluate CLI scores it."""
    from primia_tpu_torch.cli.evaluate import main as port_evaluate

    args = _args(pretrained=True)
    model, _, _ = _seeded(swin.SWIN_B)
    path = tmp_path / "swin.pt"
    ckpt.save_model(path, epoch=1, model=model, args=args,
                    val_mean_std=(np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)))
    state = ckpt.load_model(path)
    msd = state["model_state_dict"]
    assert msd["state"] == {}
    assert msd["params"]["layers"][2]["blocks"][17]["attn"]["bias_table"].shape == (25, 16)
    assert "b" not in msd["params"]["layers"][0]["downsample"]["reduction"]
    fresh = swin.SwinTransformer(input_size=RES)
    fresh.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    x = _images(2)
    with torch.no_grad():
        assert torch.equal(fresh.eval()(x), model.eval()(x))
    with pytest.warns(UserWarning, match="pretrained"):
        m = port_evaluate(["--model_weights", str(path), "--data_dir", str(fixture_dir / "test"),
                           "--device", "cpu"])
    assert m["conf_matrix"].sum() == 12


def test_train_cli_trains_swin(tmp_path, fixture_dir, monkeypatch):
    """``pneumonia-vgg.ini`` with ``model = swin-b`` at 96 px, one epoch of
    one step (batch 12, the fixture's 12 images): a final checkpoint of the
    Swin-B tree with every leaf and one Adam step."""
    from primia_tpu_torch.cli.train import main as port_train

    text = (common.ROOT / "configs" / "torch" / "pneumonia-vgg.ini").read_text()
    for old, new in (("model = vgg16", "model = swin-b"), ("batch_size = 64", "batch_size = 12"),
                     ("train_resolution = 224", f"train_resolution = {RES}"),
                     ("epochs = 40", "epochs = 1")):
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / "tiny-swin.ini"
    ini.write_text(text)
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="pretrained"):
        best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                           "--device", "cpu"])
    assert np.isfinite(best)
    final = sorted((tmp_path / "model_weights").glob("final_*.pt"))
    assert len(final) == 1
    state = ckpt.load_model(final[0])
    assert state["args"].model == "swin-b"
    params = state["model_state_dict"]["params"]
    assert [len(s["blocks"]) for s in params["layers"]] == [2, 2, 18, 2]
    assert params["patch_embed"]["proj"]["w"].shape == (4, 4, 3, 128)
    assert int(state["optim_state_dict"].step) == 1
    n = sum(p.numel() for p in swin.SwinTransformer(input_size=RES).parameters())
    assert state["optim_state_dict"].mu.shape == (n,)


# ------------------------------------------------------------ refusals

# every model that holds a window attention: the narrow Swin and a tiny
# MaxViT (stem 16, widths 32-64, depths 1-2, 64 px), refused by name
ATTENTION_MODELS = ["swin-b", "maxvit-b"]


def _attention_model(name):
    from primia_tpu_torch.nn import maxvit

    if name == "swin-b":
        return _seeded(NARROW)[0]
    return maxvit.MaxViT(input_size=64, stem_width=16, widths=(32, 64), depths=(1, 2))


@pytest.mark.parametrize("name", ATTENTION_MODELS)
def test_the_encrypted_predict_refuses_swin(name):
    from primia_tpu_torch.mpc.inference import build_encrypted_predict

    model = _attention_model(name)
    with pytest.raises(ValueError, match=f"{name}: the MPC engine has no softmax, GELU or layer"):
        build_encrypted_predict(model, _args(), [0.5] * 3, [0.25] * 3, "cpu")


@pytest.mark.parametrize("name", ATTENTION_MODELS)
@pytest.mark.parametrize("make_step,what", [("build_dp_train_step", "per-example gradient"),
                                          ("build_ghost_dp_train_step", "no per-example norm "
                                                                        "rule for attention")])
def test_the_dp_steps_refuse_swin(make_step, what, name):
    from primia_tpu_torch.train import dp

    model = _attention_model(name)
    args = _args(differentially_private=True)
    with pytest.raises(ValueError, match=f"{name}: .*{what}"):
        getattr(dp, make_step)(model, make_optimizer(args, model), args, [0.5] * 3, [0.25] * 3,
                             device="cpu")


@pytest.mark.parametrize("name", ATTENTION_MODELS)
def test_tf_export_refuses_swin(name):
    from primia_tpu_torch.nn import tf_export

    model = _attention_model(name)
    with pytest.raises(ValueError, match=f"{name}: the exporter has no window attention"):
        tf_export.make_serving_fn(model, [0.5] * 3, [0.25] * 3)
