"""MaxViT-B (``nn/maxvit.py``) on the CPU: the port against the benchmark's
plain reference (``benchmark/reference/families/maxvit.py``), which the JAX
package has no counterpart of, on seeded weights
(``benchmark.common.make_weights``); its parts (the depthwise convolution,
the grid partition, the blocks' orders, counters and spans); its train,
eval and predict steps, train CLI and checkpoint.

Where a test only needs the mechanism it takes a tiny MaxViT of the same
layout at 64 px: stem 16, two stages of widths 32 and 64 (head dim 32: 1
and 2 heads), depths 1 and 2, partition 64 // 32 = 2 on maps of 16 and 8
tokens a side. The published widths are built at 384 px (parameters) and
trained at 64 px (the step, the CLI, the checkpoint).
"""

import math
import warnings

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import common
from benchmark.reference import models as ref_models
from benchmark.reference.families import maxvit as ref_maxvit
from primia_tpu_torch import utils
from primia_tpu_torch.config import Arguments
from primia_tpu_torch.nn import core, create_model, maxvit
from primia_tpu_torch.nn.jax_params import from_jax_tree, param_leaves
from primia_tpu_torch.ops import cuda_swin_norm
from primia_tpu_torch.train import checkpoint as ckpt
from primia_tpu_torch.train.optim import make_optimizer
from primia_tpu_torch.train.steps import build_eval_step, build_predict_step, build_train_step

TINY = {"stem_width": 16, "widths": (32, 64), "depths": (1, 2)}
RES = 64


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arch(widths, res=RES):
    return {"family": "maxvit", "resolution": res, "in_channels": 3, "num_classes": 3,
            "norm": "batch_tf", "stem_width": widths["stem_width"],
            "widths": list(widths["widths"]), "depths": list(widths["depths"]),
            "head_dim": 32, "expansion": 4, "se_ratio": 0.25, "mlp_ratio": 4}


def _seeded(widths=TINY, seed=3, res=RES):
    """A MaxViT of ``widths`` with the benchmark's seeded weights, and them."""
    model = maxvit.MaxViT(num_classes=3, in_channels=3, input_size=res, **widths)
    W, B = common.make_weights(torch.Generator().manual_seed(seed), model)
    common.load_into(model, W, B)
    return model, W, B


def _images(n, seed=4, res=RES):
    return torch.randn(n, 3, res, res, generator=torch.Generator().manual_seed(seed))


# ------------------------------------------------------------------ parts

def test_a_depthwise_conv_is_f_conv2d_with_groups():
    """``Conv(groups=)``: weights (cout, cin / groups, k, k), the forward
    ``F.conv2d`` with those groups, He init over the groups' fan-out
    (sqrt(2 / 9) for a 3 x 3 depthwise conv); one group keeps the old
    init's draws."""
    g = torch.Generator().manual_seed(5)
    conv = core.Conv(512, 512, 3, 2, 1, groups=512)
    assert conv.weight.shape == (512, 1, 3, 3)
    assert float(conv.weight.detach().std()) == pytest.approx(math.sqrt(2 / 9), rel=0.05)
    x = torch.randn(2, 512, 9, 9, generator=g)
    assert torch.equal(conv(x), F.conv2d(x, conv.weight, stride=2, padding=1, groups=512))
    torch.manual_seed(6)
    w = core.Conv(3, 8, 3).weight
    torch.manual_seed(6)
    assert torch.equal(w, torch.empty(8, 3, 3, 3).normal_(std=math.sqrt(2.0 / (9 * 8))))


def test_a_grouped_conv_never_takes_the_k7_switch(monkeypatch):
    """``PRIMIA_PALLAS_WGRAD``'s ``conv3x3_s1p1`` computes one group: a
    grouped 3x3 conv that meets the switch's other conditions (bf16, 128
    input channels a group, 256 out) stays ``F.conv2d``."""
    monkeypatch.setattr(core, "use_pallas_wgrad", lambda: True)

    def refuse(*a):
        raise AssertionError("a grouped conv reached conv3x3_s1p1")

    monkeypatch.setattr(core, "conv3x3_s1p1", refuse)
    conv = core.Conv(256, 256, 3, 1, 1, groups=2).to(torch.bfloat16)
    x = torch.randn(2, 256, 4, 4).to(torch.bfloat16)
    assert torch.equal(conv(x), F.conv2d(x, conv.weight, padding=1, groups=2))


@pytest.mark.parametrize("side,grid", [(16, 2), (8, 2), (24, 12), (12, 12), (96, 12)])
def test_grid_partition_against_a_loop_over_tokens(side, grid):
    """Window (a, b) of the (side / grid)^2 windows, row-major, holds token
    (i side / grid + a, j side / grid + b) at place i grid + j; the
    reverse undoes it; and the reference's partition is the same."""
    x = torch.arange(2 * side * side * 3, dtype=torch.float32).reshape(2, side, side, 3)
    got = cuda_swin_norm.grid_partition(x, grid)
    n = side // grid
    want = torch.empty(2, n * n, grid * grid, 3)
    for a in range(n):
        for b in range(n):
            for i in range(grid):
                for j in range(grid):
                    want[:, a * n + b, i * grid + j] = x[:, i * n + a, j * n + b]
    assert torch.equal(got, want)
    assert torch.equal(cuda_swin_norm.grid_reverse(got, grid, side, side), x)
    assert torch.equal(ref_maxvit._grid_partition(x, grid), want)
    assert torch.equal(cuda_swin_norm.to_order(x, (grid, cuda_swin_norm.GRID)), want)


def test_blocks_take_the_block_and_the_grid_order():
    """At 384 px the partition is 12: every block's first attention half
    runs in the unshifted window order (12, 0), its second in the grid
    order (12, GRID); stage 4's 12 x 12 map is one window either way (12,
    0); no region mask anywhere; 3, 6, 12 and 24 heads."""
    m = maxvit.MaxViT(input_size=384)
    assert m.partition == 12
    for si, stage in enumerate(m.stages):
        for blk in stage.blocks:
            grid = (12, 0) if si == 3 else (12, cuda_swin_norm.GRID)
            assert (blk.attn_block.window, blk.attn_block.shift) == (12, 0)
            assert (blk.attn_grid.window, blk.attn_grid.shift) == grid
            assert blk.attn_block.attn_regions is None and blk.attn_grid.attn_regions is None
            assert blk.attn_block.attn.heads == (3, 6, 12, 24)[si]
            assert blk.attn_grid.attn.relative_position_bias_table.shape == (529, blk.attn_grid
                                                                               .attn.heads)
    assert [len(s.blocks) for s in m.stages] == [2, 6, 14, 2]
    assert sum(p.numel() for p in m.parameters()) == 118_886_775
    with pytest.raises(ValueError, match="multiple of 32"):
        maxvit.MaxViT(input_size=100)
    with pytest.raises(ValueError, match="built for 64 px"):
        _seeded()[0](_images(1, res=96))


def test_the_counter_and_the_spans_under_a_profiler_only():
    """Two window attention calls a block (block and grid); each block's
    three mixers close their spans once, around the attention halves' own
    ``swin.*`` spans; nothing counts or closes off the profiler."""
    model, _, _ = _seeded()
    closed = []

    def note(name, *a):
        closed.append(name)

    before = utils.counters["attention_calls"]
    saved = utils.span_closed
    utils.span_closed = note
    try:
        model(_images(1))
        assert utils.counters["attention_calls"] == before and not closed
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            model(_images(1))
    finally:
        utils.span_closed = saved
    blocks = sum(TINY["depths"])
    assert utils.counters["attention_calls"] == before + 2 * blocks
    for name, n in (("maxvit.mbconv", blocks), ("maxvit.block", blocks), ("maxvit.grid", blocks),
                    ("swin.attention", 2 * blocks), ("swin.mlp", 2 * blocks)):
        assert closed.count(name) == n, name
    # each mixer's span closes after the attention spans inside it
    assert closed[:6] == ["maxvit.mbconv", "swin.attention", "swin.mlp", "maxvit.block",
                          "swin.attention", "swin.mlp"]


# ------------------------------------------------------- against the reference

@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_logits_match_the_reference(train):
    """The tiny MaxViT at 64 px, float32: the logits within 1e-5 of the
    largest (the two sum the convolutions, the attention and the norms in
    other orders; float32 keeps about 7 digits)."""
    model, W, B = _seeded()
    x = _images(2)
    model.train(train)
    with torch.no_grad():
        taps = {}
        want = ref_models.forward(W, B, x, _arch(TINY), train, taps=taps)
        got = model(x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))
    assert taps["head_input"].shape == (2, 64)


# biases whose loss gradient is zero but for float32 rounding: a train-mode
# batch norm after a 1x1 or plain conv subtracts the batch mean, which takes
# any constant a channel away (the stem's first bias, each pre-norm's beta)
CANCELLED = ("stem.conv1.bias", "conv.pre_norm.bias")


def test_every_leaf_gradient_matches_the_reference():
    """The tiny MaxViT at 64 px, float32, train mode (the reference's blocks
    under checkpointing): every leaf's gradient, the depthwise weights, the
    squeeze-excitation and both bias tables of each block included, within
    1e-4 of its largest value (float32 rounding through the blocks and
    their recomputation); the leaves whose gradient a batch norm cancels
    within 1e-5 of the median leaf's largest, on both sides (a float32 sum
    over the batch's positions that cancels to zero leaves a few ulps of its
    terms: 1e-6 of it here)."""
    model, W, B = _seeded()
    x = _images(2)
    y = F.one_hot(torch.tensor([0, 2]), 3).float()
    model.train()
    names = [n for n, _ in param_leaves(model)]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    params = dict(model.named_parameters())
    loss = -(y * F.log_softmax(model(x), 1)).sum(1).mean()
    got = torch.autograd.grad(loss, [params[n] for n in names])
    P = {n: W[n].clone().requires_grad_(True) for n in names}
    rloss = -(y * F.log_softmax(ref_models.forward(P, B, x, _arch(TINY), True), 1)
              ).sum(1).mean()
    want = torch.autograd.grad(rloss, [P[n] for n in names])
    torch.testing.assert_close(loss, rloss, rtol=1e-5, atol=0)
    median = float(np.median([float(b.abs().max()) for b in want]))
    tables = cancelled = 0
    for n, a, b in zip(names, got, want):
        if n.endswith(CANCELLED):
            cancelled += 1
            assert max(float(a.abs().max()), float(b.abs().max())) <= 1e-5 * median, n
            continue
        scale = float(b.abs().max())
        assert scale > 0, n
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale, msg=n)
        tables += n.endswith("relative_position_bias_table")
    assert tables == 2 * sum(TINY["depths"]) and cancelled == 1 + sum(TINY["depths"])


# ------------------------------------------------------- the port's paths

def _args(**kw):
    kw = dict(dict(model="maxvit-b", batch_size=2, train_resolution=RES,
                   inference_resolution=RES, lr=1e-3, beta1=0.5, beta2=0.99, weight_decay=5e-4,
                   mixup=True, mixup_prob=0.9), **kw)
    return Arguments(**kw)


def test_create_model_builds_maxvit_b():
    """The published widths: 119,653,468 parameters at 1,000 classes and 384
    px (the authors' release: 119.65M), in eval mode and channels_last."""
    with pytest.warns(UserWarning, match="pretrained"):
        m = create_model(_args(pretrained=True, inference_resolution=384), num_classes=1000,
                         device="cpu")
    assert isinstance(m, maxvit.MaxViT) and not m.training
    assert (m.in_channels, m.num_classes, m.input_size, m.pooling, m.partition) == (
        3, 1000, 384, "avg", 12)
    assert sum(p.numel() for p in m.parameters()) == 119_653_468
    assert m.stem.conv1.weight.is_contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="normalization=group"):
        create_model(_args(normalization="group"), device="cpu")


def test_one_train_step_moves_every_leaf():
    """One step through ``build_train_step`` with the recipe's augmentation,
    MixUp and Adam, the published widths at 64 px: a finite loss, and every
    leaf moved (Adam's first step moves each leaf with a gradient by about
    lr; the L2 term moves those whose loss gradient a batch norm cancels)."""
    args = _args(pretrained=True, clahe=True, randomgamma=True, blur=True, elastic=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = create_model(args, num_classes=3, device="cpu")
    opt = make_optimizer(args, model)
    assert len(opt.params) == len(list(model.parameters()))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    imgs, labels = common.make_images(torch.Generator().manual_seed(6), 2, RES)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, opt, args, mean, std, device="cpu")
    loss = step(torch.Generator().manual_seed(7), imgs, labels.numpy(), np.ones(2, np.float32),
                args.lr)
    assert torch.isfinite(loss)
    for n, p in model.named_parameters():
        assert not torch.equal(p, before[n]), n


def test_the_eval_and_predict_steps_give_the_models_logits():
    """The float32 eval step (center crop, normalise) and the predict step
    (no CLAHE) on the same uint8 images give the eval-mode model's logits."""
    model, _, _ = _seeded()
    model = model.to(memory_format=torch.channels_last)
    args = _args(clahe=False)
    imgs, labels = common.make_images(torch.Generator().manual_seed(8), 3, RES)
    mean, std = common.mean_std(imgs)
    _, logits = build_eval_step(model, args, mean, std, device="cpu")(
        imgs, labels.numpy(), np.ones(3, np.float32))
    pred = build_predict_step(model, args, mean, std, "cpu")(imgs)
    x = (imgs.permute(0, 3, 1, 2).float() / 255.0 - torch.tensor(mean).reshape(1, 3, 1, 1)) \
        / torch.tensor(std).reshape(1, 3, 1, 1)
    with torch.no_grad():
        want = model.eval()(x.float())
    for got in (logits, pred):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_a_checkpoint_reloads_to_identical_logits(tmp_path, fixture_dir):
    """``train/checkpoint.py`` writes the published widths at 64 px (the
    depthwise weights HWIO (3, 3, 1, 4C), both bias tables of a block,
    batch-norm state, no state for layer norms); a fresh model loads it
    strictly and gives the same logits; the evaluate CLI scores it."""
    from primia_tpu_torch.cli.evaluate import main as port_evaluate

    args = _args(pretrained=True)
    model, _, _ = _seeded(maxvit.MAXVIT_B)
    path = tmp_path / "maxvit.pt"
    ckpt.save_model(path, epoch=1, model=model, args=args,
                    val_mean_std=(np.full(3, 0.5, np.float32), np.full(3, 0.25, np.float32)))
    state = ckpt.load_model(path)
    msd = state["model_state_dict"]
    blk = msd["params"]["stages"][2]["blocks"][13]
    assert blk["conv"]["conv2_kxk"]["w"].shape == (3, 3, 1, 1536)
    assert blk["attn_grid"]["attn"]["bias_table"].shape == (9, 12)
    assert set(msd["state"]["stages"][0]["blocks"][0]["conv"]) == {"pre_norm", "norm1", "norm2"}
    assert "attn_block" not in msd["state"]["stages"][0]["blocks"][0]
    fresh = maxvit.MaxViT(input_size=RES)
    fresh.load_state_dict(from_jax_tree(msd["params"], msd["state"]))
    x = _images(2)
    with torch.no_grad():
        assert torch.equal(fresh.eval()(x), model.eval()(x))
    with pytest.warns(UserWarning, match="pretrained"):
        m = port_evaluate(["--model_weights", str(path), "--data_dir", str(fixture_dir / "test"),
                           "--device", "cpu"])
    assert m["conf_matrix"].sum() == 12


def test_train_cli_trains_maxvit(tmp_path, fixture_dir, monkeypatch):
    """``pneumonia-vgg.ini`` with ``model = maxvit-b`` at 64 px, one epoch of
    one step (batch 12, the fixture's 12 images): a final checkpoint of the
    MaxViT-B tree with every leaf and one Adam step."""
    from primia_tpu_torch.cli.train import main as port_train

    text = (common.ROOT / "configs" / "torch" / "pneumonia-vgg.ini").read_text()
    for old, new in (("model = vgg16", "model = maxvit-b"), ("batch_size = 64", "batch_size = 12"),
                     ("train_resolution = 224", f"train_resolution = {RES}"),
                     ("epochs = 40", "epochs = 1")):
        assert old in text, old
        text = text.replace(old, new)
    ini = tmp_path / "tiny-maxvit.ini"
    ini.write_text(text)
    monkeypatch.chdir(tmp_path)
    with pytest.warns(UserWarning, match="pretrained"):
        best = port_train(["--config", str(ini), "--data_dir", str(fixture_dir / "train"),
                           "--device", "cpu"])
    assert np.isfinite(best)
    final = sorted((tmp_path / "model_weights").glob("final_*.pt"))
    assert len(final) == 1
    state = ckpt.load_model(final[0])
    assert state["args"].model == "maxvit-b"
    params = state["model_state_dict"]["params"]
    assert [len(s["blocks"]) for s in params["stages"]] == [2, 6, 14, 2]
    assert params["stem"]["conv1"]["w"].shape == (3, 3, 3, 64)
    assert int(state["optim_state_dict"].step) == 1
    n = sum(p.numel() for p in maxvit.MaxViT(input_size=RES).parameters())
    assert state["optim_state_dict"].mu.shape == (n,)


# ----------------------------------------------------------------- the card

@pytest.mark.cuda
def test_a_maxvit_step_launches_the_attention_and_norm_kernels():
    """A MaxViT-B train step at 384 px (batch 2) on the card: 48 forward and
    48 backward window-attention launches (each block's block and grid
    attention) and 97 of each layer-norm direction (four a block, the
    head's), a finite loss.

    It imports nothing of JAX:

        python -m pytest --noconftest -m cuda tests/test_torch_maxvit.py
    """
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from primia_tpu_torch.ops._build import read_launches

    dev = torch.device("cuda")
    cfg = common.load_json(common.BENCH_DIR / "configs" / "maxvit_b384.json")
    args = Arguments.from_dict(dict(cfg["args"], batch_size=2))
    with pytest.warns(UserWarning, match="pretrained"):
        model = create_model(args, num_classes=3, device=dev)
    g = torch.Generator(device=dev).manual_seed(45)
    imgs, labels = common.make_images(g, 2, 384)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, make_optimizer(args, model), args, mean, std, device=dev)
    mask = torch.ones(2)
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    before = read_launches()
    loss = step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    after = read_launches()
    names = ("window_attention_fwd", "window_attention_bwd", "swin_norm_fwd", "swin_norm_bwd")
    assert [after[k] - before[k] for k in names] == [48, 48, 97, 97]
    assert torch.isfinite(loss)


@pytest.mark.cuda
def test_the_float32_eval_and_predict_steps_on_the_card_match_the_cpu():
    """The tiny MaxViT's eval and predict steps on the card, float32 (the
    attention kernels' and the norms' float32 builds, cuDNN's depthwise
    convolution, no TF32), give the CPU's logits within 1e-4 of the largest
    (float32 sums in other orders through three blocks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    model, _, _ = _seeded()
    args = _args(clahe=False)
    imgs, labels = common.make_images(torch.Generator().manual_seed(9), 4, RES)
    mean, std = common.mean_std(imgs)
    mask = np.ones(4, np.float32)
    want = build_eval_step(model, args, mean, std, device="cpu")(imgs, labels.numpy(), mask)[1]
    card = model.to(dev, memory_format=torch.channels_last)
    _, logits = build_eval_step(card, args, mean, std, device=dev)(imgs, labels.numpy(), mask)
    pred = build_predict_step(card, args, mean, std, dev)(imgs)
    for got in (logits, pred):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4 * float(want.abs().max()))
