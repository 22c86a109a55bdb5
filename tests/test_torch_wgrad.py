"""K7, the 3x3/s1/p1 weight gradient, and the conv that runs it, against
the JAX package's ``ops/pallas_wgrad.py``.

The port's plain version against ``conv3x3_wgrad_pallas`` and its v2 in
interpret mode, the autograd Function against the JAX ``custom_vjp``, and
``nn/core.py:Conv``'s dispatch under ``PRIMIA_PALLAS_WGRAD``, on the CPU.
Inputs are made with numpy, rounded to bfloat16 once and handed to both
packages. Each test states its limit.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.ops.pallas_wgrad as jw
from primia_tpu_torch.nn import core
from primia_tpu_torch.nn.core import Conv
from primia_tpu_torch.ops import cuda_wgrad
from primia_tpu_torch.ops._build import read_launches


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16_pair(rng, shape, scale=1.0):
    """The same bfloat16 values as a JAX (B, H, W, C) array and a torch
    (B, C, H, W) channels_last tensor."""
    a = jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)
    return a, t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _hwio(dw: torch.Tensor) -> np.ndarray:
    """OIHW (co, ci, 3, 3) -> HWIO (3, 3, ci, co)."""
    return dw.permute(2, 3, 1, 0).numpy()


# the shapes of tests/test_pallas.py's K7 tests, and one at 128 channels
SHAPES = [(4, 8, 8, 8, 16), (3, 9, 11, 8, 8), (2, 5, 7, 16, 8), (2, 14, 14, 32, 32),
          (2, 6, 5, 128, 128)]


@pytest.mark.parametrize("version", ["v1", "v2"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_wgrad_matches_the_pallas_kernels(shape, version):
    """Within 1e-3 of max |dW| (the JAX tests' limit against XLA's wgrad):
    both sum the same bfloat16 products in float32, in other orders."""
    B, H, W, ci, co = shape
    rng = np.random.default_rng(sum(shape))
    xj, xt = _bf16_pair(rng, (B, H, W, ci))
    gj, gt = _bf16_pair(rng, (B, H, W, co))
    pallas = jw.conv3x3_wgrad_pallas if version == "v1" else jw.conv3x3_wgrad_pallas_v2
    want = np.asarray(pallas(xj, gj, interpret=True))
    port = cuda_wgrad.conv3x3_wgrad if version == "v1" else cuda_wgrad.conv3x3_wgrad_v2
    got = port(xt, gt)
    assert got.dtype == torch.float32 and got.shape == (co, ci, 3, 3)
    np.testing.assert_allclose(_hwio(got), want, rtol=0, atol=1e-3 * np.abs(want).max())


def test_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(5)
    _, xt = _bf16_pair(rng, (2, 5, 6, 16))
    _, gt = _bf16_pair(rng, (2, 5, 6, 8))
    before = read_launches()
    torch.testing.assert_close(cuda_wgrad.conv3x3_wgrad(xt, gt),
                               cuda_wgrad.conv3x3_wgrad_plain(xt, gt), rtol=0, atol=0)
    assert read_launches() == before
    with pytest.raises(ValueError):
        cuda_wgrad.conv3x3_wgrad(xt, gt[:, :, :4])


# (B, H, W, ci, co): the train step's layer2 and layer3, and ragged ones (H
# not a multiple of the box's rows, W of 16, channels not of 64, channels
# under a box's 64, one pixel row, a wide image)
PLAN_SHAPES = [(200, 28, 28, 128, 128), (200, 14, 14, 256, 256), (3, 9, 11, 64, 64),
               (1, 1, 7, 512, 512), (2, 13, 28, 72, 136), (4, 7, 14, 128, 128),
               (1, 3, 3, 8, 16), (2, 5, 7, 512, 64), (200, 56, 56, 64, 64), (2, 3, 300, 16, 24)]


def _boxes(plan, B):
    """Every box of the plan's K axis, in the kernel's (image, box row, box
    column) order: (b, h0, w0)."""
    return [(j // (plan.nwb * plan.nhb), (j // plan.nwb) % plan.nhb * plan.hb,
             j % plan.nwb * plan.wb) for j in range(plan.boxes)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: f"{s[0] * s[1] * s[2]}-{s[3]}-{s[4]}")
def test_pixel_splits_cover_the_pixels_once(shape):
    """K7's plan: its boxes cover every pixel once and stay within TMA's
    limits; its splits cover every box once, none empty; its tiles cover
    every (tap, 64-channel block) of M and of N once; its grid fits one
    wave of the card (132 SMs, one block an SM)."""
    B, H, W, ci, co = shape
    plan = cuda_wgrad.plan_wgrad(B, ci, co, H, W)
    # the box: 64 channels of 2 bytes (one 128-byte swizzle row), each
    # extent at most 256, a multiple of wgmma's K of 16 pixels
    assert cuda_wgrad._BOX_CHANNELS * 2 == 128
    assert 1 <= plan.wb <= 256 and 1 <= plan.hb <= 256
    assert plan.box_pixels % 16 == 0 and plan.box_pixels <= 112
    cover = torch.zeros((B, H, W), dtype=torch.int32)
    for b, h0, w0 in _boxes(plan, B):
        cover[b, h0:h0 + plan.hb, w0:w0 + plan.wb] += 1
    assert bool((cover == 1).all())
    assert plan.boxes == B * plan.nhb * plan.nwb
    # the splits
    assert plan.splits * plan.per_split >= plan.boxes > (plan.splits - 1) * plan.per_split
    assert 1 <= plan.splits <= 65535
    # the tiles: the 3 row taps of one x block against the 3 column taps of
    # one g block, every (tap, block) once
    m = [(kh, tm) for tm in range(plan.tiles_m) for kh in range(3)]
    n = [(kw, tn) for tn in range(plan.tiles_n) for kw in range(3)]
    assert sorted(m) == [(kh, c) for kh in range(3) for c in range(-(-ci // 64))]
    assert sorted(n) == [(kw, c) for kw in range(3) for c in range(-(-co // 64))]
    # one wave; at least 2 stages of an x box and 3 g boxes in the shared
    # memory
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.wave == 132
    assert plan.blocks <= max(plan.wave, tiles)
    most = max(1, min(plan.boxes, plan.wave // tiles))
    assert plan.splits <= most and plan.per_split == -(-plan.boxes // most)
    assert 2 <= plan.stages and plan.smem <= 232448
    x_box = plan.wb * (plan.hb + 2) * 128
    assert plan.smem >= plan.stages * (x_box + 3 * plan.box_pixels * 128)


def test_plan_fills_the_wave_its_occupancy_gives():
    """Two blocks an SM double the wave, so the train step's layer2 call
    takes half the boxes a split (22 of its 1,400, in 64 splits: none
    empty); the occupancy is asked at the plan's own shared memory."""
    asked = []
    one = cuda_wgrad.plan_wgrad(200, 128, 128, 28, 28)
    two = cuda_wgrad.plan_wgrad(200, 128, 128, 28, 28, sms=132,
                                blocks_per_sm=lambda smem: asked.append(smem) or 2)
    assert asked == [one.smem]
    assert (one.tiles_m, one.tiles_n, one.splits, one.per_split, one.blocks) == (2, 2, 33, 43, 132)
    assert (two.wave, two.per_split, two.splits, two.blocks) == (264, 22, 64, 256)


def _box_of(t, c0, w0, h0, b, wb, hb):
    """TMA's box of ``t`` (B, C, H, W): 64 channels from c0, hb rows from
    h0, wb columns from w0 of image b, zero outside the tensor, as
    (hb*wb pixels in (h, w) order, 64)."""
    _, C, H, W = t.shape
    box = torch.zeros((64, hb, wb))
    cs, ce, hs, he, ws, we = max(c0, 0), min(c0 + 64, C), max(h0, 0), min(h0 + hb, H), \
        max(w0, 0), min(w0 + wb, W)
    if cs < ce and hs < he and ws < we:
        box[cs - c0:ce - c0, hs - h0:he - h0, ws - w0:we - w0] = t[b, cs:ce, hs:he, ws:we]
    return box.reshape(64, hb * wb).T


def _tiled_sum(x, g, plan):
    """The kernel's sum in plain PyTorch: for each split, tile and box, the
    product of the x box (rows h0-1 .. h0+hb, read from row kh for tap kh)
    and the g boxes (columns from w0+1-kw) into the split's dW; then the
    reduce: the splits summed in order."""
    B, ci, H, W = x.shape
    co = g.shape[1]
    x, g = x.float(), g.float()
    ws = torch.zeros((plan.splits, co, ci, 3, 3))
    boxes = _boxes(plan, B)
    rows = plan.box_pixels
    for s in range(plan.splits):
        for b, h0, w0 in boxes[s * plan.per_split:(s + 1) * plan.per_split]:
            for tm in range(plan.tiles_m):
                xbox = _box_of(x, tm * 64, w0, h0 - 1, b, plan.wb, plan.hb + 2)
                for tn in range(plan.tiles_n):
                    for kh in range(3):
                        a = xbox[kh * plan.wb:kh * plan.wb + rows]
                        for kw in range(3):
                            gb = _box_of(g, tn * 64, w0 + 1 - kw, h0, b, plan.wb, plan.hb)
                            part = (a.T @ gb).T  # (o, c) of the two 64-channel blocks
                            oc, cc = min(64, co - tn * 64), min(64, ci - tm * 64)
                            ws[s, tn * 64:tn * 64 + oc, tm * 64:tm * 64 + cc, kh, kw] += \
                                part[:oc, :cc]
    total = ws[0]
    for s in range(1, plan.splits):
        total = total + ws[s]
    return total


@pytest.mark.parametrize("shape", [(2, 13, 28, 72, 136), (4, 7, 14, 128, 128), (1, 3, 3, 8, 16),
                                   (3, 9, 11, 64, 64), (2, 5, 7, 24, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_tiled_sum_of_the_plan_matches_plain(shape):
    """The plan's boxes, shifts, zero fill, tiles and splits, run in plain
    PyTorch (a card of 5 SMs, so that K splits unevenly), give
    conv3x3_wgrad_plain's dW within 1e-5 of its max (float32 sums of the
    same products in another order)."""
    B, H, W, ci, co = shape
    rng = np.random.default_rng(sum(shape))
    _, x = _bf16_pair(rng, (B, H, W, ci))
    _, g = _bf16_pair(rng, (B, H, W, co))
    plan = cuda_wgrad.plan_wgrad(B, ci, co, H, W, sms=5)
    want = cuda_wgrad.conv3x3_wgrad_plain(x, g)
    torch.testing.assert_close(_tiled_sum(x, g, plan), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("ci,co", [(8, 16), (128, 128), (512, 512)])
def test_conv3x3_s1p1_grads_match_the_jax_custom_vjp(ci, co):
    """dx and dW of sum(sin(conv)) against JAX's ``conv3x3_s1p1`` (its
    v2 kernel in interpret mode, as tests/test_pallas.py runs it): within
    2e-2 of each one's max |value|, that test's limit. At 512 channels
    both take the library's weight gradient."""
    rng = np.random.default_rng(ci + co)
    B, H, W = 2, 7, 9
    xj, xt = _bf16_pair(rng, (B, H, W, ci))
    wj = jnp.asarray(rng.standard_normal((3, 3, ci, co)) * 0.1, jnp.bfloat16)
    wt = torch.from_numpy(np.asarray(wj, np.float32)).permute(3, 2, 0, 1).to(torch.bfloat16)

    orig = jw.conv3x3_wgrad_pallas_v2
    with mock.patch.dict(os.environ, {"PRIMIA_PALLAS_INTERPRET": "1"}), \
            mock.patch.object(jw, "conv3x3_wgrad_pallas_v2",
                              lambda x_, g_: orig(x_, g_, interpret=True)):
        gx_r, gw_r = jax.grad(
            lambda a, b: jnp.sum(jnp.sin(jw.conv3x3_s1p1(a, b).astype(jnp.float32))),
            (0, 1))(xj, wj)

    xt.requires_grad_(True)
    wt.requires_grad_(True)
    before = read_launches()["conv3x3_wgrad"]
    calls = []
    plain = cuda_wgrad.conv3x3_wgrad_plain
    with mock.patch.object(cuda_wgrad, "conv3x3_wgrad_plain",
                           lambda *a: calls.append(1) or plain(*a)):
        y = cuda_wgrad.conv3x3_s1p1(xt, wt)
        gx, gw = torch.autograd.grad(torch.sin(y.float()).sum(), (xt, wt))
    assert len(calls) == (1 if max(ci, co) <= 256 else 0)
    assert read_launches()["conv3x3_wgrad"] == before  # the CPU runs no kernel
    assert gx.dtype == gw.dtype == torch.bfloat16
    for got, ref in ((gx.float().permute(0, 2, 3, 1).numpy(), gx_r),
                     (_hwio(gw.float()), gw_r)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-2 * max(1e-9, np.abs(ref).max()))


def _conv_grads(conv, x, switch: bool, monkeypatch):
    monkeypatch.setenv("PRIMIA_PALLAS_WGRAD", "1" if switch else "0")
    calls = []
    plain = cuda_wgrad.conv3x3_wgrad_plain
    with mock.patch.object(cuda_wgrad, "conv3x3_wgrad_plain",
                           lambda *a: calls.append(1) or plain(*a)):
        with torch.autocast("cpu", dtype=torch.bfloat16):
            y = conv(x)
        gw, = torch.autograd.grad(torch.sin(y.float()).sum(), (conv.weight,))
    return y, gw, len(calls)


def test_conv_takes_k7_under_the_switch_in_bfloat16_autocast(monkeypatch):
    """Under PRIMIA_PALLAS_WGRAD=1 and bfloat16 autocast a 128-channel
    3x3/s1/p1 conv runs K7's plain version once a backward; its output
    equals the default path's, and the float32 weight gradient is a
    bfloat16 value within 1e-2 of max |dW| of the default path's
    (autocast's bfloat16 gradient): both round a float32 sum to bfloat16."""
    torch.manual_seed(0)
    conv = Conv(128, 128, 3, 1, 1).to(memory_format=torch.channels_last)
    x = torch.randn(2, 128, 6, 5).contiguous(memory_format=torch.channels_last)
    y_on, gw_on, n_on = _conv_grads(conv, x, True, monkeypatch)
    y_off, gw_off, n_off = _conv_grads(conv, x, False, monkeypatch)
    assert (n_on, n_off) == (1, 0)
    torch.testing.assert_close(y_on, y_off, rtol=0, atol=0)
    assert gw_on.dtype == torch.float32 and gw_on.shape == conv.weight.shape
    torch.testing.assert_close(gw_on, gw_on.to(torch.bfloat16).float(), rtol=0, atol=0)
    scale = float(gw_off.abs().max())
    torch.testing.assert_close(gw_on, gw_off, rtol=0, atol=1e-2 * scale)


@pytest.mark.parametrize("case", ["meets_it", "64_channels", "stride_2", "batch_1",
                                  "float32"])
def test_conv_dispatch_follows_the_jax_condition(case, monkeypatch):
    """The JAX package's condition (nn/core.py:50-56): 3x3, stride 1, pad
    1, batch above 1, ci and co at least 128, computed in bfloat16; any
    other conv keeps the library path."""
    torch.manual_seed(1)
    cin = 64 if case == "64_channels" else 128
    conv = Conv(cin, 128, 3, 2 if case == "stride_2" else 1, 1)
    x = torch.randn(1 if case == "batch_1" else 2, cin, 6, 6)
    monkeypatch.setenv("PRIMIA_PALLAS_WGRAD", "1")
    calls = []
    with mock.patch.object(core, "conv3x3_s1p1", lambda *a: calls.append(1)):
        with torch.autocast("cpu", dtype=torch.bfloat16, enabled=case != "float32"):
            conv(x)
    assert calls == ([1] if case == "meets_it" else [])


def test_switch_reads_the_jax_variable(monkeypatch):
    monkeypatch.delenv("PRIMIA_PALLAS_WGRAD", raising=False)
    assert not cuda_wgrad.use_pallas_wgrad()
    monkeypatch.setenv("PRIMIA_PALLAS_WGRAD", "1")
    assert cuda_wgrad.use_pallas_wgrad()
    monkeypatch.setenv("PRIMIA_PALLAS_WGRAD", "0")
    assert not cuda_wgrad.use_pallas_wgrad()
