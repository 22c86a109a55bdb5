"""The Swin-B train path's kernels on the card: the augmentation's K1 and
3-channel CLAHE at the ``swin_b384.train`` batch (64 x 3 x 384²), where
they run at 384 px, bit for bit with their plain versions; the window
attention kernels (``ops/cuda_attention.py``) against their plain version
at Swin-B's four stage shapes, masked and unmasked, in bf16 and float32, at
a padded L = 49, with the bias gradient the same bits twice and the
wrapper's refusals; and a Swin-B train step at 384 px, whose window
attentions launch those kernels, named with the benchmark's token
(``benchmark/attention.py:KERNEL_TOKEN``) and nothing of PyTorch's fused
attention, and its eval and predict steps in float32.

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_swin_cuda.py
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.ops import cuda_attention, cuda_clahe, cuda_tent

SHAPE = (64, 3, 384, 384)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [1, 2])
def test_k1_at_384_px_matches_plain(cuda_device, axis):
    """K1 on the cell's planes, positions spread past both edges with some
    integers (exact taps): bit for bit, one launch."""
    B, C, H, W = SHAPE
    rng = np.random.default_rng(21)
    planes = torch.from_numpy(rng.random((B * C, H, W), dtype=np.float32)).to(cuda_device)
    q = rng.uniform(-3.0, H + 2.0, (B, H, W)).astype(np.float32)
    q[:, ::7] = np.round(q[:, ::7])
    q = torch.from_numpy(q).to(cuda_device)
    before = cuda_tent.launches["tent_rows"]
    got = cuda_tent.tent_rows(planes, q, axis=axis)
    assert cuda_tent.launches["tent_rows"] == before + 1
    assert torch.equal(got, cuda_tent.tent_rows_plain(planes, q, axis=axis))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "grey_xray"])
def test_clahe_lab_at_384_px_matches_plain(cuda_device, kind):
    """The 3-channel CLAHE kernel on the cell's batch (48 x 48 tiles of 2,304
    pixels: a clip height of 9, so its float32 sums stay exact): bit for
    bit with the plain composition, one launch, the same bits twice. Random
    colour images, and grey X-ray-like images as the cell makes them."""
    B, C, H, W = SHAPE
    if kind == "random":
        g = torch.Generator(device=cuda_device).manual_seed(22)
        x = torch.rand((B, C, H, W), generator=g, device=cuda_device)
    else:
        from benchmark import common

        g = torch.Generator(device=cuda_device).manual_seed(23)
        u8, _ = common.make_images(g, B, H)
        x = (u8.permute(0, 3, 1, 2).float() / 255.0).contiguous()
    plan = cuda_clahe.cluster_plan(H, W, 8, lab=True)
    assert plan["max_active_clusters"] > 0
    before = dict(cuda_clahe.launches)
    out = cuda_clahe.clahe_rgb(x)
    assert cuda_clahe.launches["clahe_lab"] == before["clahe_lab"] + 1
    want = cuda_clahe.clahe_rgb_plain(x)
    d = (out - want).abs()
    assert torch.equal(out, want), (f"{int((d > 0).sum())} of {d.numel()} values differ, "
                                    f"by up to {float(d.max()) * 255.0} levels")
    assert torch.equal(cuda_clahe.clahe_rgb(x), out)


# --------------------------------------------------------- window attention

# (heads, windows an image) of Swin-B's four stages at 384 px, cut to 4
# windows an image; 26 images, so that every CTA walks several windows
STAGES = {"stage1": 4, "stage2": 8, "stage3": 16, "stage4": 32}
B_W, NW_W = 26, 4


def _operands(dev, dtype, B, nW, h, L, masked, seed):
    """q, k, v as the model passes them (strided views of one qkv output), a
    bias as the model gathers it (an (L, L, h) gather seen as (h, L, L)),
    region ids or None, and an output gradient as proj hands it back."""
    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = torch.randn((B, nW, L, 3 * h * 32), generator=g, device=dev).to(dtype)
    q, k, v = (t.transpose(2, 3) for t in qkv.reshape(B, nW, L, 3, h, 32).unbind(3))
    bias = torch.randn((L, L, h), generator=g, device=dev).permute(2, 0, 1)
    regions = None
    if masked:
        # four regions over the window's tokens, a different cut a window
        cut = torch.arange(L, device=dev)
        regions = torch.stack([(cut >= 7 * w + 3).int() + 2 * (cut % (w + 2) == 0).int()
                               for w in range(nW)])
    do = torch.randn((B, nW, L, h, 32), generator=g, device=dev).to(dtype).permute(0, 1, 3, 2, 4)
    return q, k, v, bias, regions, do


def _rel(got, want):
    """|got - want| / |want|, Frobenius norms in float64."""
    want = want.detach().double()
    return float((got.detach().double() - want).norm() / want.norm())


def _kernels_against_plain(q, k, v, bias, regions, do):
    """Each of o, dq, dk, dv, dbias from the kernels, and its gap from the
    plain version computed in float64 from the same inputs."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    before = dict(cuda_attention.launches)
    o = cuda_attention.window_attention(*leaves, regions)
    grads = torch.autograd.grad(o, leaves, do)
    assert cuda_attention.launches["window_attention_fwd"] == before["window_attention_fwd"] + 1
    assert cuda_attention.launches["window_attention_bwd"] == before["window_attention_bwd"] + 1
    ref = [t.detach().double().requires_grad_() for t in (q, k, v, bias)]
    want = cuda_attention.window_attention_plain(*ref, regions)
    wgrads = torch.autograd.grad(want, ref, do.double())
    names = ("o", "dq", "dk", "dv", "dbias")
    return {n: _rel(a, b) for n, a, b in zip(names, (o, *grads), (want, *wgrads))}


# bf16: o, dq, dk and dv are bf16 (2^-9 relative a value), and P and dS are
# rounded to bf16 before their products; their norms' gaps read a few 1e-3.
# dbias sums float32 dS, computed from float32 P and dP: ~1e-6. float32:
# CUDA-core FMAs and expf, against float64: ~1e-7.
TOLERANCE = {torch.bfloat16: {"o": 1e-2, "dq": 2e-2, "dk": 2e-2, "dv": 1e-2, "dbias": 1e-4},
             torch.float32: {n: 1e-5 for n in ("o", "dq", "dk", "dv", "dbias")}}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_window_attention_kernels_against_plain(cuda_device, stage, masked, dtype):
    """The kernel pair at a Swin-B stage's heads (L = 144) on strided
    operands as the model hands them: o and the four gradients within
    their dtype's tolerance of the plain version in float64."""
    ops = _operands(cuda_device, dtype, B_W, NW_W, STAGES[stage], 144, masked, 31)
    gaps = _kernels_against_plain(*ops)
    assert all(gaps[n] < TOLERANCE[dtype][n] for n in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_window_attention_kernels_at_a_padded_l_of_49(cuda_device, masked, dtype):
    """Window 7 (224 px): L = 49, padded to 64 inside the bf16 build."""
    ops = _operands(cuda_device, dtype, B_W, NW_W, 4, 49, masked, 32)
    gaps = _kernels_against_plain(*ops)
    assert all(gaps[n] < TOLERANCE[dtype][n] for n in gaps), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_the_bias_gradient_is_the_same_bits_twice(cuda_device, dtype):
    """No atomics: the backward's outputs, the bias gradient summed from the
    CTAs' partials in a fixed order included, are the same bits twice."""
    q, k, v, bias, regions, do = _operands(cuda_device, dtype, 64, NW_W, 4, 144, True, 33)
    o, lse = cuda_attention.forward(q, k, v, bias.float(), regions)
    first = cuda_attention.backward(q, k, v, do, bias.float(), regions, lse)
    second = cuda_attention.backward(q, k, v, do, bias.float(), regions, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert float(first[3].abs().max()) > 0


@pytest.mark.cuda
def test_operands_off_the_kernels_layout_are_copied_first(cuda_device):
    """q, k, v whose d is not contiguous (the kernels read 16-byte rows) are
    copied into a layout the kernels read: the same bits as the call on
    contiguous copies, forward and backward."""
    q, k, v, bias, regions, do = _operands(cuda_device, torch.bfloat16, 4, NW_W, 4, 144, True, 34)
    odd = [t.transpose(-1, -2).contiguous().transpose(-1, -2) for t in (q, k, v)]
    assert all(t.stride(-1) != 1 for t in odd)
    outs = []
    for ops in (odd, [t.contiguous() for t in (q, k, v)]):
        leaves = [t.detach().requires_grad_() for t in (*ops, bias)]
        o = cuda_attention.window_attention(*leaves, regions)
        outs.append((o, *torch.autograd.grad(o, leaves, do)))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bias_shape,match", [
    ((2, 4, 4, 144, 64), (4, 144, 144), "head dim 32"),
    ((2, 1, 4, 196, 32), (4, 196, 196), "at most 144 tokens"),
    ((2, 4, 4, 144, 32), (4, 144, 143), r"bias must be \(4, 144, 144\)"),
])
def test_the_wrapper_raises_on_what_the_kernels_do_not_take(cuda_device, shape, bias_shape,
                                                             match):
    q = torch.zeros(shape, dtype=torch.bfloat16, device=cuda_device)
    before = dict(cuda_attention.launches)
    with pytest.raises(ValueError, match=match):
        cuda_attention.window_attention(q, q, q, torch.zeros(bias_shape, device=cuda_device))
    assert cuda_attention.launches == before


def _swin_b(cuda_device, batch):
    from benchmark import common
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model

    cfg = common.load_json(common.BENCH_DIR / "configs" / "swin_b384.json")
    args = Arguments.from_dict(dict(cfg["args"], batch_size=batch))
    with pytest.warns(UserWarning, match="pretrained"):
        model = create_model(args, num_classes=3, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(24)
    imgs, labels = common.make_images(g, batch, 384)
    return args, model, g, imgs, labels, common.mean_std(imgs)


@pytest.mark.cuda
def test_a_swin_step_launches_the_window_attention_kernels(cuda_device):
    """A Swin-B train step at 384 px (batch 2) under the profiler: its 24
    window attentions launch 24 kernels named with ``fmha_cutlassF`` and
    their backward ones named with ``fmha_cutlassB`` (a kernel and a
    finalize each), all found by the benchmark's token; no kernel of
    PyTorch's fused attention and no ``aten::scaled_dot_product_attention``."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import attention
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    args, model, g, imgs, labels, (mean, std) = _swin_b(cuda_device, 2)
    opt = make_optimizer(args, model)
    step = build_train_step(model, opt, args, mean, std, device=cuda_device)
    mask = torch.ones(2)
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    before = dict(cuda_attention.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(g, imgs, labels, mask, args.lr)
        torch.cuda.synchronize()
    assert cuda_attention.launches == {"window_attention_fwd": before["window_attention_fwd"] + 24,
                                       "window_attention_bwd": before["window_attention_bwd"] + 24}
    counts = {e.key: e.count for e in prof.key_averages()}
    fwd = sum(n for k, n in counts.items() if "fmha_cutlassF" in k)
    bwd = sum(n for k, n in counts.items() if "fmha_cutlassB" in k)
    assert (fwd, bwd) == (24, 48), counts
    assert all(attention.is_kernel(k) for k in counts if "fmha" in k)
    assert not any("PyTorchMemEffAttention" in k or "scaled_dot_product" in k for k in counts)


@pytest.mark.cuda
def test_a_swin_step_allocates_nothing_of_the_logits_size(cuda_device):
    """A Swin-B train step at 384 px (batch 8, where every call's (B nW, h,
    L, L) logits hold more than one (L, L) slice an SM): no operation gives
    a tensor of trailing dims (L, L) with more than one slice an SM, which
    the bias gradient's partials (one a CTA, a CTA an SM) take at most."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    B, L = 8, 144
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    windows = {"stage1": 64, "stage2": 16, "stage3": 4, "stage4": 1}
    assert all(B * windows[s] * h > sms for s, h in STAGES.items())
    args, model, g, imgs, labels, (mean, std) = _swin_b(cuda_device, B)
    step = build_train_step(model, make_optimizer(args, model), args, mean, std,
                            device=cuda_device)
    mask = torch.ones(B)
    seen = []

    class Shapes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in out if isinstance(out, (tuple, list)) else (out,):
                if isinstance(t, torch.Tensor) and t.dim() >= 2 and t.shape[-2:] == (L, L):
                    seen.append((str(func), tuple(t.shape)))
            return out

    with Shapes():
        step(g, imgs, labels, mask, args.lr)
        torch.cuda.synchronize()
    assert any("empty" in f for f, _ in seen), "the bias gradient's partials were not seen"
    assert all(torch.Size(s).numel() <= sms * L * L for _, s in seen), seen


@pytest.mark.cuda
def test_swin_eval_and_predict_in_float32_match_the_plain_attention(cuda_device, monkeypatch):
    """The eval and predict steps run Swin-B in float32 (TF32 off) through
    the float32 build, one forward launch a block; their logits are within
    1e-4 of the largest logit of the same steps with the plain attention
    (float32 on both sides; 24 blocks of attentions that agree to ~1e-7)."""
    from primia_tpu_torch.nn import swin
    from primia_tpu_torch.train.steps import build_eval_step, build_predict_step

    args, model, g, imgs, labels, (mean, std) = _swin_b(cuda_device, 2)
    ev = build_eval_step(model, args, mean, std, device=cuda_device)
    pr = build_predict_step(model, args, mean, std, cuda_device, apply_clahe=False)
    mask = torch.ones(2)
    before = cuda_attention.launches["window_attention_fwd"]
    got = (ev(imgs, labels, mask)[1], pr(imgs))
    assert cuda_attention.launches["window_attention_fwd"] == before + 48
    monkeypatch.setattr(swin.cuda_attention, "window_attention",
                        cuda_attention.window_attention_plain)
    want = (ev(imgs, labels, mask)[1], pr(imgs))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), (a, b)
