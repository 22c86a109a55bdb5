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
    before = dict(cuda_wgrad.launches)
    torch.testing.assert_close(cuda_wgrad.conv3x3_wgrad(xt, gt),
                               cuda_wgrad.conv3x3_wgrad_plain(xt, gt), rtol=0, atol=0)
    assert cuda_wgrad.launches == before
    with pytest.raises(ValueError):
        cuda_wgrad.conv3x3_wgrad(xt, gt[:, :, :4])


@pytest.mark.parametrize("P,ci,co", [(156_800, 128, 128), (39_200, 256, 256), (297, 64, 64),
                                     (7, 512, 512)])
def test_pixel_splits_cover_the_pixels_once(P, ci, co):
    splits, chunk = cuda_wgrad.split_pixels(P, ci, co)
    assert chunk % cuda_wgrad._STEP == 0 and splits * chunk >= P > (splits - 1) * chunk
    assert splits <= 65535


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
    before = cuda_wgrad.launches["conv3x3_wgrad"]
    calls = []
    plain = cuda_wgrad.conv3x3_wgrad_plain
    with mock.patch.object(cuda_wgrad, "conv3x3_wgrad_plain",
                           lambda *a: calls.append(1) or plain(*a)):
        y = cuda_wgrad.conv3x3_s1p1(xt, wt)
        gx, gw = torch.autograd.grad(torch.sin(y.float()).sum(), (xt, wt))
    assert len(calls) == (1 if max(ci, co) <= 256 else 0)
    assert cuda_wgrad.launches["conv3x3_wgrad"] == before  # the CPU runs no kernel
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
