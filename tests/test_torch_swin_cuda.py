"""The Swin-B train path's kernels on the card: the augmentation's K1 and
3-channel CLAHE at the ``swin_b384.train`` batch (64 x 3 x 384²), where
they run at 384 px, bit for bit with their plain versions; and a Swin-B
train step at 384 px, whose window attention launches PyTorch's
memory-efficient SDPA kernels (``benchmark/attention.py:KERNEL_TOKEN``).

Every test here is marked ``cuda`` and skips without a CUDA device. The
file imports nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_swin_cuda.py
"""

import numpy as np
import pytest
import torch

from primia_tpu_torch.ops import cuda_clahe, cuda_tent

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


@pytest.mark.cuda
def test_a_swin_step_launches_the_efficient_sdpa_kernels(cuda_device):
    """A Swin-B train step at 384 px (batch 2) under the profiler: its 24
    window attentions launch the memory-efficient backend's forward and
    backward kernels, once a block each way: none falls to the math
    backend."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark import attention, common
    from primia_tpu_torch.config import Arguments
    from primia_tpu_torch.nn import create_model
    from primia_tpu_torch.train.optim import make_optimizer
    from primia_tpu_torch.train.steps import build_train_step

    cfg = common.load_json(common.BENCH_DIR / "configs" / "swin_b384.json")
    args = Arguments.from_dict(dict(cfg["args"], batch_size=2))
    with pytest.warns(UserWarning, match="pretrained"):
        model = create_model(args, num_classes=3, device=cuda_device)
    opt = make_optimizer(args, model)
    g = torch.Generator(device=cuda_device).manual_seed(24)
    imgs, labels = common.make_images(g, 2, 384)
    mean, std = common.mean_std(imgs)
    step = build_train_step(model, opt, args, mean, std, device=cuda_device)
    mask = torch.ones(2)
    step(g, imgs, labels, mask, args.lr)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step(g, imgs, labels, mask, args.lr)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()]
    counts = {e.key: e.count for e in prof.key_averages()}
    fwd = sum(counts[n] for n in names if "fmha_cutlassF" in n)
    bwd = sum(counts[n] for n in names if "fmha_cutlassB" in n)
    assert (fwd, bwd) == (24, 24), names
    assert all(attention.is_kernel(n) for n in names if "fmha" in n)
