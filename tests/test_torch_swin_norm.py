"""Swin's fused layer norms (``ops/cuda_swin_norm.py:add_norm``): on the CPU,
the plain version against the composition it replaces (``F.layer_norm``,
``torch.roll``, the window partition; the window reverse, the roll back
and the residual add), bit for bit in float32, forward and gradients, at
Swin-B's stage maps at 384 px (window 12) and 224 px (window 7), a window
equal to the map, and the widths 128 to 2048; MaxViT-B's grid order
(``GRID``) against its partition written as reshapes here, at its stage
maps and widths 96 to 768, in float32 and bf16; a whole Swin-B block and a
grid-attention block against the old formula written out; the refusals. Marked ``cuda`` (they skip
without a card): the kernels against the plain version in every dtype the
model hands them, the gamma and beta gradients the same bits twice, and a
Swin-B train step's launches, with no roll left in its device operations.

The ``cuda`` tests import nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_swin_norm.py
"""

import pytest
import torch
import torch.nn.functional as F

from primia_tpu_torch.nn import swin
from primia_tpu_torch.ops import cuda_swin_norm as csn
from primia_tpu_torch.ops._build import read_launches

EPS = 1e-5


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _params(C, g, device="cpu"):
    w = (1.0 + 0.1 * torch.randn(C, generator=g)).to(device).requires_grad_()
    b = (0.1 * torch.randn(C, generator=g)).to(device).requires_grad_()
    return w, b


def _grid(x, G):
    """MaxViT's grid partition as torch reshapes: window (a, b) of the
    (H / G) x (W / G) windows holds the tokens (i H / G + a, j W / G + b)."""
    B, H, W, C = x.shape
    return x.reshape(B, G, H // G, G, W // G, C).permute(0, 2, 4, 1, 3, 5).reshape(
        B, (H // G) * (W // G), G * G, C)


def _ungrid(y, G, H, W):
    B, _, _, C = y.shape
    return y.reshape(B, H // G, W // G, G, G, C).permute(0, 3, 1, 4, 2, 5).reshape(B, H, W, C)


def _ordered(x, window, shift):
    """The old block's way to its windows: roll, then the partition (or
    the grid partition)."""
    if shift == csn.GRID:
        return _grid(x, window)
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    return csn.window_partition(x, window)


def _natural(y, window, shift, H, W):
    """The old block's way back: the reverse, then the roll back."""
    if shift == csn.GRID:
        return _ungrid(y, window, H, W)
    y = csn.window_reverse(y, window, H, W)
    return torch.roll(y, (shift, shift), (1, 2)) if shift else y


# (map side, window, shift, C): Swin-B's stages at 384 px (window 12, the
# odd blocks shifted by 6; stage 4's map is one window) and at 224 px
# (window 7, shift 3), a wider C at each map, up to the last merge's 2048
CASES = [(96, 12, 0, 128), (96, 12, 6, 128), (48, 12, 6, 256), (24, 12, 0, 512),
         (24, 12, 6, 2048), (12, 12, 0, 1024), (56, 7, 3, 128), (28, 7, 3, 256),
         (14, 7, 3, 512), (7, 7, 0, 1024),
         # MaxViT-B's grid order at its stage maps and widths at 384 px (grid
         # 12: stage 4's map is one window), and at 224 px (grid 7)
         (96, 12, csn.GRID, 96), (48, 12, csn.GRID, 192), (24, 12, csn.GRID, 384),
         (12, 12, csn.GRID, 768), (56, 7, csn.GRID, 96)]


@pytest.mark.parametrize("side,window,shift,C", CASES)
def test_plain_norm1_is_the_old_composition(side, window, shift, C):
    """No branch, y at the block's order: ``F.layer_norm``, the roll and the
    window partition, bit for bit, forward and the gradients of x, gamma and
    beta; the residual stream passes through, its gradient added to x's as
    autograd adds the old block's two uses of x."""
    g = torch.Generator().manual_seed(side + C + shift)
    x = torch.randn(1, side, side, C, generator=g, requires_grad=True)
    w, b = _params(C, g)
    s, y = csn.add_norm(x, w, b, EPS, out_order=(window, shift), out_dtype=torch.float32)
    want = _ordered(F.layer_norm(x, (C,), w, b, EPS), window, shift)
    assert y.shape == ((1, (side // window) ** 2, window ** 2, C))
    assert torch.equal(s, x) and torch.equal(y, want)
    up_s, up_y = torch.randn(s.shape, generator=g), torch.randn(y.shape, generator=g)
    got = torch.autograd.grad((s, y), (x, w, b), (up_s, up_y))
    ref = list(torch.autograd.grad(want, (x, w, b), up_y))
    ref[0] = ref[0] + up_s
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize("side,window,shift,C", CASES)
def test_plain_norm2_is_the_old_composition(side, window, shift, C):
    """The branch at the block's order: the window reverse, the roll back,
    ``x + y`` and ``F.layer_norm``, bit for bit, forward (the sum and y)
    and the gradients of x, the branch, gamma and beta from both outputs'."""
    g = torch.Generator().manual_seed(2 * side + C + shift)
    x = torch.randn(1, side, side, C, generator=g, requires_grad=True)
    branch = torch.randn(1, (side // window) ** 2, window ** 2, C, generator=g,
                         requires_grad=True)
    w, b = _params(C, g)
    s, y = csn.add_norm(x, w, b, EPS, branch=branch, branch_order=(window, shift),
                        out_dtype=torch.float32)
    s_old = x + _natural(branch, window, shift, side, side)
    y_old = F.layer_norm(s_old, (C,), w, b, EPS)
    assert torch.equal(s, s_old) and torch.equal(y, y_old)
    ups = [torch.randn(t.shape, generator=g) for t in (s, y)]
    got = torch.autograd.grad((s, y), (x, branch, w, b), ups)
    ref = torch.autograd.grad((s_old, y_old), (x, branch, w, b), ups)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


def test_plain_add_norm_rounds_as_autocast_would():
    """bf16 x and branch add in bf16 (their sum is bf16); the layer norm runs
    in float32 and y is rounded once to the dtype asked for; a float32 x
    with a bf16 branch sums in float32."""
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 6, 6, 32, generator=g)
    br = torch.randn(2, 4, 9, 32, generator=g).bfloat16()
    w, b = _params(32, g)
    for xs in (x.bfloat16(), x):
        s, y = csn.add_norm(xs, w, b, EPS, branch=br, branch_order=(3, 1),
                            out_dtype=torch.bfloat16)
        want = xs + _natural(br, 3, 1, 6, 6)
        assert s.dtype == want.dtype == xs.dtype and torch.equal(s, want)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, F.layer_norm(want.float(), (32,), w, b, EPS).bfloat16())


@pytest.mark.parametrize("xdtype", [torch.float32, torch.bfloat16])
def test_plain_grid_order_rounds_as_autocast_would(xdtype):
    """MaxViT's grid attention on its bf16 stream (a convolution's output
    under autocast) and on the eval step's float32 one, C 96: norm1 writes
    y at the grid order and norm2 reads the bf16 branch from it, the sum
    in x's dtype and the layer norm in float32 rounded once to bf16, bit
    for bit the composition with the grid written as reshapes, forward and
    the gradients of x, the branch, gamma and beta."""
    g = torch.Generator().manual_seed(8)
    x = torch.randn(2, 24, 24, 96, generator=g).to(xdtype).requires_grad_()
    br = torch.randn(2, 4, 144, 96, generator=g).bfloat16().requires_grad_()
    w, b = _params(96, g)
    order = (12, csn.GRID)
    s1, y1 = csn.add_norm(x, w, b, EPS, out_order=order, out_dtype=torch.bfloat16)
    want1 = _grid(F.layer_norm(x.float(), (96,), w, b, EPS), 12).bfloat16()
    assert s1 is x and y1.dtype == torch.bfloat16 and torch.equal(y1, want1)
    s2, y2 = csn.add_norm(x, w, b, EPS, branch=br, branch_order=order, out_dtype=torch.bfloat16)
    s_old = x + _ungrid(br, 12, 24, 24)
    y_old = F.layer_norm(s_old.float(), (96,), w, b, EPS).bfloat16()
    assert s2.dtype == xdtype and torch.equal(s2, s_old) and torch.equal(y2, y_old)
    ups = [torch.randn(t.shape, generator=g).to(t.dtype) for t in (s2, y2)]
    got = torch.autograd.grad((s2, y2), (x, br, w, b), ups)
    ref = torch.autograd.grad((s_old, y_old), (x, br, w, b), ups)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize("shift", [0, 6, csn.GRID])
def test_a_swin_b_block_is_the_old_formula(shift):
    """A stage-1 Swin-B block (C 128, 4 heads) on a 24 x 24 map at window 12,
    regular, shifted or in MaxViT's grid order (a grid of 12), float32: its
    forward and the gradients of its input and every parameter are the old
    block's formula, written out here, bit for bit."""
    torch.manual_seed(11 + shift)
    blk = swin.SwinBlock(128, 4, 24, 12, shift)
    with torch.no_grad():
        for n in (blk.norm1, blk.norm2):
            n.weight.normal_(1.0, 0.1)
            n.bias.normal_(0.0, 0.1)
    x = torch.randn(2, 24, 24, 128, requires_grad=True)
    params = [x, *blk.parameters()]

    def old(x):
        y = F.layer_norm(x, (128,), blk.norm1.weight, blk.norm1.bias, EPS)
        y = blk.attn(_ordered(y, 12, shift), blk.attn_regions)
        x = x + _natural(y, 12, shift, 24, 24)
        return x + blk.mlp(F.layer_norm(x, (128,), blk.norm2.weight, blk.norm2.bias, EPS))

    out, want = blk(x), old(x)
    assert torch.equal(out, want)
    up = torch.randn(out.shape)
    got = torch.autograd.grad(out, params, up)
    ref = torch.autograd.grad(want, params, up)
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


@pytest.mark.parametrize("kw,match", [
    ({"x": (2, 6, 32)}, r"\(B, H, W, C\) map"),
    ({"w": (31,)}, r"gamma and beta must be \(32,\)"),
    ({"out_order": (4, 1)}, r"order \(4, 1\) does not fit a 6 x 6 map"),
    ({"out_order": (3, 3)}, r"order \(3, 3\) does not fit"),
    ({"out_order": (4, csn.GRID)}, r"order \(4, -1\) does not fit a 6 x 6 map"),
    ({"out_order": (3, -2)}, r"order \(3, -2\) does not fit"),
    ({"branch": (2, 6, 6, 32), "branch_order": (3, 1)}, r"branch must be \(2, 4, 9, 32\)"),
    ({"branch_order": (3, 1)}, "a branch order without a branch"),
])
def test_add_norm_refuses_what_the_kernels_do_not_take(kw, match):
    """The wrapper's checks hold on every device, the CPU's plain version
    included."""
    x = torch.zeros(kw.get("x", (2, 6, 6, 32)))
    w = torch.ones(kw.get("w", (32,)))
    branch = torch.zeros(kw["branch"]) if "branch" in kw else None
    with pytest.raises(ValueError, match=match):
        csn.add_norm(x, w, torch.zeros(32), EPS, branch=branch,
                     branch_order=kw.get("branch_order"), out_order=kw.get("out_order"),
                     out_dtype=torch.float32)


# ----------------------------------------------------------------- the card

def _bf16_ulp(t):
    """The spacing of bfloat16 values at each |t| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0 ** -126))) - 7)


def _y_reference(s, w, b, order):
    """The layer norm of s in float64 at ``order``, and what y may differ
    from it by: one bf16 ulp, plus 8 float32 ulps of the terms that float32
    rounds on the way, (|s| + |mean|) rstd |gamma| + |beta| (s - mean
    rounds at the scale of s, not of the difference). That rounding shows
    where y is near 0 and bf16 finer than it. (PyTorch's float32 layer norm
    on the card, the plain version, sums by Welford's method and is off by
    more, so y is held to float64.)"""
    s64 = s.double()
    mean = s64.mean(-1, keepdim=True)
    rstd = (s64.var(-1, unbiased=False, keepdim=True) + EPS).rsqrt()
    y64 = (s64 - mean) * rstd * w.double() + b.double()
    terms = (s64.abs() + mean.abs()) * rstd * w.double().abs() + b.double().abs()
    return (csn.to_order(y64, order),
            csn.to_order(_bf16_ulp(y64) + 2.0 ** -21 * terms, order))


def _rel(got, want):
    want = want.detach().double()
    return float((got.detach().double() - want).norm() / want.norm())


# (B, side, window, shift, C): the stage maps at 384 px and 224 px, the merge
# norms' widths, and C 96 (a row of 24 chunks: part of a warp idle)
CARD_CASES = [(4, 96, 12, 6, 128), (4, 48, 12, 6, 256), (8, 24, 12, 0, 512),
              (8, 12, 12, 0, 1024), (8, 12, 12, 0, 2048), (4, 56, 7, 3, 128), (4, 7, 7, 0, 1024),
              (2, 8, 4, 2, 96),
              # MaxViT-B's grid order at its four stage maps and widths, and its
              # block order at stage 1's (C 96: 24 chunks, a warp's last 8
              # lanes idle; C 192, 384, 768: a team's last chunk idle)
              (2, 96, 12, csn.GRID, 96), (2, 48, 12, csn.GRID, 192),
              (4, 24, 12, csn.GRID, 384), (8, 12, 12, csn.GRID, 768), (2, 96, 12, 0, 96)]
# (x, branch, y) as the model hands them: the train step's norm1 and norm2
# in stage 1 (a float32 stream) and in stages 2-4 (a bf16 stream: the
# merges' linear output), the embedding's and the final norm (bf16 in,
# float32 out), the eval and predict steps' norms (float32 throughout)
DTYPES = {"norm1_f32_stream": (torch.float32, None, torch.bfloat16),
          "norm1_bf16_stream": (torch.bfloat16, None, torch.bfloat16),
          "norm2_f32_stream": (torch.float32, torch.bfloat16, torch.bfloat16),
          "norm2_bf16_stream": (torch.bfloat16, torch.bfloat16, torch.bfloat16),
          "head": (torch.bfloat16, None, torch.float32),
          "eval_norm1": (torch.float32, None, torch.float32),
          "eval_norm2": (torch.float32, torch.float32, torch.float32)}


def _card_operands(dev, case, dtypes, seed):
    B, side, window, shift, C = case
    g = torch.Generator(device=dev).manual_seed(seed)
    xd, bd, _ = dtypes
    x = (torch.randn((B, side, side, C), generator=g, device=dev) * 2 + 0.5).to(xd)
    branch = None
    if bd is not None:
        branch = torch.randn((B, (side // window) ** 2, window ** 2, C), generator=g,
                             device=dev).to(bd)
    w = 1.0 + 0.1 * torch.randn(C, generator=g, device=dev)
    b = 0.1 * torch.randn(C, generator=g, device=dev)
    return x, branch, w, b


def _both(x, branch, w, b, order, out_dtype, seed):
    """The kernels' and the plain version's outputs and gradients, from the
    same inputs and upstream gradients: a dict a side."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    kw = dict(out_dtype=out_dtype)
    if branch is None:
        kw["out_order"] = order
    else:
        kw.update(branch_order=order)
    sides = {}
    for name, fn in (("kernel", csn.add_norm), ("plain", csn.add_norm_plain)):
        leaves = [t.detach().requires_grad_() for t in (x, w, b)]
        br = None if branch is None else branch.detach().requires_grad_()
        outs = fn(leaves[0], leaves[1], leaves[2], EPS, branch=br, **kw)
        if not sides:
            ups = [torch.randn(t.shape, generator=g, device=x.device).to(t.dtype) for t in outs]
        wrt = leaves + ([] if br is None else [br])
        grads = torch.autograd.grad(outs, wrt, ups)
        names = ["dx", "dgamma", "dbeta"] + ([] if br is None else ["dbranch"])
        sides[name] = {"s": outs[0], "y": outs[1], **dict(zip(names, grads))}
    return sides["kernel"], sides["plain"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", list(DTYPES))
@pytest.mark.parametrize("case", CARD_CASES, ids=lambda c: "x".join(map(str, c)))
def test_the_kernels_against_plain(cuda_device, case, dtypes):
    """One forward and one backward launch; the residual stream the same
    bits as the plain add (x itself without a branch); y within one bf16
    ulp of the layer norm rounded once, plus the float32 rounding of its
    terms (:func:`_y_reference`; float32 y: 1e-5 of the largest); dx and the branch's gradient within a norm gap of 1e-5 of the
    plain version's in float32, 4e-3 (one bf16 ulp) where they are bf16;
    dgamma and dbeta, float32 sums over every row in another order, within
    1e-5."""
    od = DTYPES[dtypes][2]
    x, branch, w, b = _card_operands(cuda_device, case, DTYPES[dtypes], 41)
    order = case[2:4]
    before = read_launches()
    got, want = _both(x, branch, w, b, order, od, 42)
    after = read_launches()
    assert [after[k] - before[k] for k in ("swin_norm_fwd", "swin_norm_bwd")] == [1, 1]
    assert got["s"].dtype == want["s"].dtype and torch.equal(got["s"], want["s"])
    y64, tol = _y_reference(want["s"].detach(), w, b, None if branch is not None else order)
    assert got["y"].dtype == od and got["y"].shape == y64.shape
    err = (got["y"].detach().double() - y64).abs()
    if od == torch.bfloat16:
        assert bool((err <= tol).all()), float((err / tol).max())
    else:
        assert float(err.max()) <= 1e-5 * float(y64.abs().max())
    for n in ("dx", "dbranch"):
        if n in got:
            assert got[n].dtype == want[n].dtype
            tol = 4e-3 if got[n].dtype == torch.bfloat16 else 1e-5
            assert _rel(got[n], want[n]) < tol, (n, _rel(got[n], want[n]))
    for n in ("dgamma", "dbeta"):
        assert _rel(got[n], want[n]) < 1e-5, (n, _rel(got[n], want[n]))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [128, 2048])
def test_the_gamma_and_beta_gradients_are_the_same_bits_twice(cuda_device, C):
    """No atomics: two backward calls on the same inputs give the same bits,
    dx, the branch's gradient and the per-CTA sums of dgamma and dbeta
    included."""
    x, branch, w, b = _card_operands(cuda_device, (4, 24, 12, 6, C),
                                     DTYPES["norm2_f32_stream"], 43)
    y, s, stats = csn.forward(x, w, b, EPS, branch, (12, 6), None, torch.bfloat16)
    dy = torch.randn(y.shape, device=cuda_device).bfloat16()
    ds = torch.randn(s.shape, device=cuda_device)
    first = csn.backward(dy, ds, s, stats, w, x.dtype, branch.dtype, (12, 6), None)
    second = csn.backward(dy, ds, s, stats, w, x.dtype, branch.dtype, (12, 6), None)
    assert all(torch.equal(a, c) for a, c in zip(first, second))
    assert float(first[2].abs().max()) > 0 and float(first[3].abs().max()) > 0


# what a Swin-B step no longer runs: PyTorch's roll and layer norm, their
# kernels and their CPU ops
REPLACED = ("roll_cuda_kernel", "aten::roll", "layer_norm", "LayerNorm", "GammaBeta")


@pytest.mark.cuda
def test_a_swin_step_launches_the_norm_kernels_and_no_roll(cuda_device):
    """A Swin-B train step at 384 px (batch 2) under the profiler: 53 forward
    and 53 backward launches (48 block norms, 3 merge norms, the
    embedding's and the final norm), no roll kernel and no PyTorch layer
    norm kernel among its device operations."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import common
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    cfg = common.load_json(common.BENCH_DIR / "configs" / "swin_b384.json")
    args = Arguments.from_dict(dict(cfg["args"], batch_size=2))
    with pytest.warns(UserWarning, match="pretrained"):
        model = create_model(args, num_classes=3, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(44)
    imgs, labels = common.make_images(g, 2, 384)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, make_optimizer(args, model), args, mean, std,
                            device=cuda_device)
    mask = torch.ones(2)
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    before = read_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(g, imgs, labels, mask, args.lr)
        torch.cuda.synchronize()
    after = read_launches()
    assert [after[k] - before[k] for k in ("swin_norm_fwd", "swin_norm_bwd")] == [53, 53]
    keys = [e.key for e in prof.key_averages()]
    assert sum(e.count for e in prof.key_averages() if "swin_norm_fwd_kernel" in e.key) == 53
    gone = [k for k in keys if any(t in k for t in REPLACED)]
    assert not gone, gone
