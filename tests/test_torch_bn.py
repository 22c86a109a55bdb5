"""K8, the batch-norm channel sums, and the batch norm built on them,
against the JAX package's ``ops/pallas_bn.py``.

The port's plain sums against ``channel_sums`` and ``grad_channel_sums``
run as Pallas kernels in interpret mode (``PRIMIA_PALLAS_INTERPRET=1``),
its ``bn_train`` against the JAX ``custom_vjp``, and ``nn/core.py:Norm``
under ``PRIMIA_PALLAS_BN`` against ``nn/core.py:batch_norm(train=True)``
with the JAX switch patched on, on the CPU. Inputs are made with numpy,
rounded to bfloat16 once and handed to both packages. Each test states
its limit.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import primia_tpu.ops.pallas_bn as jbn
from primia_tpu.nn.core import PLAIN
from primia_tpu.nn.core import batch_norm as jax_batch_norm
from primia_tpu_torch.nn.core import Norm
from primia_tpu_torch.ops import cuda_bn
from primia_tpu_torch.ops._build import read_launches


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _interpret():
    return mock.patch.dict(os.environ, {"PRIMIA_PALLAS_INTERPRET": "1"})


def _bf16_pair(rng, shape, scale=1.0, shift=0.0):
    """The same bfloat16 values as a JAX (B, H, W, C) array and a torch
    (B, C, H, W) channels_last tensor."""
    a = jnp.asarray(rng.standard_normal(shape) * scale + shift, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)
    return a, t.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)


def _close(got: torch.Tensor, want, rel: float):
    """Within ``rel`` of the largest |value| of ``want``."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=rel * max(1e-9, np.abs(want).max()))


# tests/test_pallas.py's shapes: (128, 4, 4, 8) and (130, 3, 5, 16) take the
# TPU's batch-minor kernels, the rest the row-major or folded ones
SHAPES = [(4, 10, 10, 64), (2, 7, 7, 128), (5, 3, 3, 8), (128, 4, 4, 8), (130, 3, 5, 16)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_channel_sums_match_the_pallas_kernels(shape):
    """(sum x, sum x^2) within 1e-5 of their largest |value|: the same
    bfloat16 values summed in float32 in other orders."""
    rng = np.random.default_rng(sum(shape))
    xj, xt = _bf16_pair(rng, shape, 2.0, 1.0)
    with _interpret():
        want = jbn.channel_sums(xj)
    got = cuda_bn.channel_sums(xt)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == (shape[-1],)
        _close(a, b, 1e-5)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_grad_channel_sums_match_the_pallas_kernels(shape):
    """(sum g, sum g*x) within 1e-5 of their largest |value|."""
    rng = np.random.default_rng(sum(shape) + 1)
    xj, xt = _bf16_pair(rng, shape)
    gj, gt = _bf16_pair(rng, shape)
    with _interpret():
        want = jbn.grad_channel_sums(gj, xj)
    got = cuda_bn.grad_channel_sums(gt, xt)
    for a, b in zip(got, want):
        _close(a, b, 1e-5)


def test_sums_take_any_layout_and_rows_on_the_cpu():
    """A contiguous NCHW tensor and a (rows, C) matrix give the sums of
    the channels_last one; the CPU launches nothing and copies nothing it
    counts; other dtypes are refused."""
    rng = np.random.default_rng(3)
    _, xt = _bf16_pair(rng, (3, 5, 4, 16))
    ref = cuda_bn.channel_sums(xt)
    before = (read_launches(), dict(cuda_bn.layout_copies))
    for other in (xt.contiguous(), xt.permute(0, 2, 3, 1).reshape(-1, 16)):
        for a, b in zip(cuda_bn.channel_sums(other), ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (read_launches(), cuda_bn.layout_copies) == before
    with pytest.raises(ValueError):
        cuda_bn.channel_sums(xt.float())
    with pytest.raises(ValueError):
        cuda_bn.grad_channel_sums(xt, xt[:2])


def test_bn_train_matches_the_jax_custom_vjp():
    """y within 2e-2 of max |y| (both round y to bfloat16, at other
    places), mean within 1e-5 and var within 1e-4 (the JAX test's limits),
    and the gradients of x, gamma and beta within 2e-2 of their max |value|
    (the JAX test's limit)."""
    rng = np.random.default_rng(1)
    B, H, W, C = 3, 6, 5, 16
    xj, xt = _bf16_pair(rng, (B, H, W, C), 1.0, 0.5)
    gj = jnp.asarray(rng.standard_normal(C) * 0.3 + 1, jnp.bfloat16)
    bj = jnp.asarray(rng.standard_normal(C) * 0.2, jnp.bfloat16)
    goj, got_ = _bf16_pair(rng, (B, H, W, C))

    def loss(x_, ga, be):
        return jnp.sum(jbn.bn_train(x_, ga, be)[0].astype(jnp.float32)
                       * goj.astype(jnp.float32))

    with _interpret():
        y_r, m_r, v_r = jbn.bn_train(xj, gj, bj)
        grads_r = jax.grad(loss, (0, 1, 2))(xj, gj, bj)

    gamma = torch.from_numpy(np.asarray(gj, np.float32)).requires_grad_(True)
    beta = torch.from_numpy(np.asarray(bj, np.float32)).requires_grad_(True)
    xt.requires_grad_(True)
    y, mean, var = cuda_bn.bn_train(xt, gamma, beta)
    assert y.dtype == torch.bfloat16 and y.is_contiguous(memory_format=torch.channels_last)
    assert mean.dtype == var.dtype == torch.float32 and not mean.requires_grad
    _close(y.permute(0, 2, 3, 1), y_r, 2e-2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(m_r), atol=1e-5)
    np.testing.assert_allclose(var.numpy(), np.asarray(v_r), atol=1e-4)

    gx, gg, gb = torch.autograd.grad((y.float() * got_.float()).sum(), (xt, gamma, beta))
    assert gx.dtype == torch.bfloat16 and gg.dtype == gb.dtype == torch.float32
    _close(gx.permute(0, 2, 3, 1), grads_r[0], 2e-2)
    _close(gg, grads_r[1], 2e-2)
    _close(gb, grads_r[2], 2e-2)


def _counting(calls):
    plain_s, plain_g = cuda_bn.channel_sums_plain, cuda_bn.grad_channel_sums_plain
    return (mock.patch.object(cuda_bn, "channel_sums_plain",
                              lambda *a: calls.append("s") or plain_s(*a)),
            mock.patch.object(cuda_bn, "grad_channel_sums_plain",
                              lambda *a: calls.append("g") or plain_g(*a)))


def test_norm_under_the_switch_matches_jax_batch_norm(monkeypatch):
    """``Norm`` in train mode on a bfloat16 activation under
    PRIMIA_PALLAS_BN=1 against ``batch_norm(train=True)`` with the JAX
    switch patched on: one forward and one backward sum; y within 2e-2 of
    max |y|; the running mean and (unbiased) variance within 1e-5; the
    count up by one."""
    rng = np.random.default_rng(4)
    B, H, W, C = 4, 5, 6, 32
    xj, xt = _bf16_pair(rng, (B, H, W, C), 1.5, 0.3)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.normal(0, 0.2, C).astype(np.float32)
    mean0 = rng.normal(0, 0.1, C).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    with _interpret(), mock.patch.object(jbn, "use_pallas_bn", lambda: True):
        y_r, st = jax_batch_norm(PLAIN, xj, {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                                 {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0),
                                  "count": np.int64(4)}, train=True)

    norm = Norm(C)
    norm.load_state_dict({"weight": torch.from_numpy(g), "bias": torch.from_numpy(b),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0),
                          "num_batches_tracked": torch.tensor(4)})
    monkeypatch.setenv("PRIMIA_PALLAS_BN", "1")
    calls = []
    sums, gsums = _counting(calls)
    xt.requires_grad_(True)
    with sums, gsums:
        y = norm.train()(xt)
        torch.autograd.grad(y.float().sum(), (xt, norm.weight))
    assert calls == ["s", "g"]
    _close(y.permute(0, 2, 3, 1), y_r, 2e-2)
    np.testing.assert_allclose(norm.running_mean.numpy(), np.asarray(st["mean"]), atol=1e-5)
    np.testing.assert_allclose(norm.running_var.numpy(), np.asarray(st["var"]), atol=1e-5)
    assert int(norm.num_batches_tracked) == int(st["count"]) == 5


@pytest.mark.parametrize("case", ["switch_off", "float32", "eval"])
def test_norm_keeps_f_batch_norm_outside_the_switch(case, monkeypatch):
    monkeypatch.setenv("PRIMIA_PALLAS_BN", "0" if case == "switch_off" else "1")
    x = torch.randn(2, 8, 3, 3)
    if case != "float32":
        x = x.to(torch.bfloat16)
    norm = Norm(8).train(case != "eval")
    calls = []
    sums, gsums = _counting(calls)
    with sums, gsums:
        norm(x)
    assert calls == []


def test_switch_reads_the_jax_variable(monkeypatch):
    monkeypatch.delenv("PRIMIA_PALLAS_BN", raising=False)
    assert not cuda_bn.use_pallas_bn()
    monkeypatch.setenv("PRIMIA_PALLAS_BN", "1")
    assert cuda_bn.use_pallas_bn()


def test_plain_bn_matches_the_jax_custom_vjp_with_running_statistics():
    """The plain forward and backward that the CPU runs (sums, finalize
    with the running statistics' update, apply; gradient sums, finalize,
    dx) against ``bn_train``'s ``custom_vjp`` (Pallas in interpret mode)
    and ``nn/core.py:batch_norm``'s update, each limit from what differs:

    - mean, biased var: float32 sums of the same bfloat16 values in other
      orders, within 1e-5 of mean |x| and mean x^2;
    - running mean and var: that, times the momentum, plus 1e-6 of each;
    - y: JAX rounds inv, off, x*inv and the sum to bfloat16, the port the
      float32 result once; each rounding moves a value by at most 2^-8 of
      its size, so |d| <= 2^-8 (2 |x inv| + |off| + |y_jax| + |y_port|),
      plus 1e-5 of |x inv| + |off| for the statistics;
    - dgamma, dbeta: the gradient sums in other orders, within 1e-5 of r
      (sum |g x| + |mean| sum |g|) and of sum |g|;
    - dx: one bfloat16 rounding each side, 2^-8 (|dx_jax| + |dx_port|),
      plus 1e-4 of max |dx| for the coefficients' sums.
    """
    rng = np.random.default_rng(6)
    B, H, W, C = 4, 7, 6, 24
    xj, xt = _bf16_pair(rng, (B, H, W, C), 1.3, 0.4)
    goj, got_ = _bf16_pair(rng, (B, H, W, C), 0.2, 0.05)
    g = rng.uniform(0.5, 1.5, C).astype(np.float32)
    b = rng.normal(0, 0.2, C).astype(np.float32)
    rm0 = rng.normal(0, 0.1, C).astype(np.float32)
    rv0 = rng.uniform(0.5, 1.5, C).astype(np.float32)
    m, eps, n = 0.1, 1e-5, B * H * W

    def loss(x_, ga, be):
        return jnp.sum(jbn.bn_train(x_, ga, be, eps)[0].astype(jnp.float32)
                       * goj.astype(jnp.float32))

    with _interpret():
        y_r, m_r, v_r = (np.asarray(a, np.float32) for a in
                         jbn.bn_train(xj, jnp.asarray(g), jnp.asarray(b), eps))
        dx_r, dg_r, db_r = (np.asarray(a, np.float32) for a in
                            jax.grad(loss, (0, 1, 2))(xj, jnp.asarray(g), jnp.asarray(b)))
        with mock.patch.object(jbn, "use_pallas_bn", lambda: True):
            _, st = jax_batch_norm(PLAIN, xj, {"gamma": jnp.asarray(g), "beta": jnp.asarray(b)},
                                   {"mean": jnp.asarray(rm0), "var": jnp.asarray(rv0),
                                    "count": np.int64(0)}, train=True, momentum=m, eps=eps)

    gamma = torch.from_numpy(g).requires_grad_(True)
    beta = torch.from_numpy(b).requires_grad_(True)
    rm, rv = torch.from_numpy(rm0.copy()), torch.from_numpy(rv0.copy())
    xt.requires_grad_(True)
    y, mean, var = cuda_bn.bn_train(xt, gamma, beta, eps, rm, rv, m)
    dx, dg, db = torch.autograd.grad(y, (xt, gamma, beta), got_)

    xf = np.asarray(xj, np.float32)
    gf = np.asarray(goj, np.float32)
    tol_mean = 1e-5 * np.abs(xf).mean()
    tol_var = 1e-5 * np.square(xf).mean()
    np.testing.assert_allclose(mean.numpy(), m_r, rtol=0, atol=tol_mean)
    np.testing.assert_allclose(var.numpy(), v_r, rtol=0, atol=tol_var)
    np.testing.assert_allclose(rm.numpy(), np.asarray(st["mean"]), rtol=1e-6, atol=m * tol_mean)
    np.testing.assert_allclose(rv.numpy(), np.asarray(st["var"]), rtol=1e-6,
                               atol=m * n / (n - 1) * tol_var)

    r_r = 1.0 / np.sqrt(v_r + eps)
    inv = g * r_r
    off = b - m_r * inv
    xinv = np.abs(xf * inv)
    yp = y.detach().permute(0, 2, 3, 1).float().numpy()
    bound = 2.0 ** -8 * (2 * xinv + np.abs(off) + np.abs(y_r) + np.abs(yp)) + 1e-5 * (
        xinv + np.abs(off))
    assert np.all(np.abs(yp - y_r) <= bound)

    sums_g = np.abs(gf).sum((0, 1, 2))
    np.testing.assert_array_less(np.abs(dg.numpy() - dg_r), 1e-5 * r_r * (
        np.abs(gf * xf).sum((0, 1, 2)) + np.abs(m_r) * sums_g) + 1e-30)
    np.testing.assert_array_less(np.abs(db.numpy() - db_r), 1e-5 * sums_g + 1e-30)
    dxp = dx.permute(0, 2, 3, 1).float().numpy()
    assert np.all(np.abs(dxp - dx_r) <= 2.0 ** -8 * (np.abs(dx_r) + np.abs(dxp))
                  + 1e-4 * np.abs(dx_r).max())


def test_bn_launch_plain_versions_compose_the_previous_ops():
    """On the CPU the six wrappers run their plain versions; split
    partials sum to the same statistics, and a model's running statistics
    move only when given."""
    rng = np.random.default_rng(8)
    _, x = _bf16_pair(rng, (3, 4, 5, 16), 1.0, 0.3)
    _, gy = _bf16_pair(rng, (3, 4, 5, 16), 0.1)
    gamma, beta = torch.rand(16) + 0.5, torch.randn(16) * 0.1
    n = x.numel() // 16
    before = read_launches()
    part = cuda_bn.channel_partials(x)
    assert part.shape == (1, 2, 16)
    stats = cuda_bn.bn_finalize(part, gamma, beta, n, 1e-5)
    split = torch.stack([part[0] * 0.25, part[0] * 0.75])
    torch.testing.assert_close(cuda_bn.bn_finalize(split, gamma, beta, n, 1e-5), stats,
                               rtol=1e-6, atol=1e-6)
    mean, r, inv, off = stats[2], stats[4], stats[5], stats[6]
    # the plain versions against the formulas of pallas_bn.py
    xf = x.float()
    torch.testing.assert_close(mean, xf.mean((0, 2, 3)), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(inv, gamma * torch.rsqrt(stats[3] + 1e-5), rtol=0, atol=0)
    y = cuda_bn.bn_apply(x, inv, off)
    torch.testing.assert_close(y, (xf * inv.reshape(1, -1, 1, 1) + off.reshape(1, -1, 1, 1))
                               .to(torch.bfloat16), rtol=0, atol=0)
    coef = cuda_bn.bn_grad_finalize(cuda_bn.grad_channel_partials(gy, x), gamma, mean, r, n)
    S1, dgamma, A, B, D = coef[0], coef[2], coef[3], coef[4], coef[5]
    torch.testing.assert_close(S1, gy.float().sum((0, 2, 3)), rtol=1e-6, atol=1e-6)
    xhat = (xf - mean.reshape(1, -1, 1, 1)) * r.reshape(1, -1, 1, 1)
    torch.testing.assert_close(dgamma, (gy.float() * xhat).sum((0, 2, 3)), rtol=1e-5, atol=1e-5)
    dx = cuda_bn.bn_dx(gy, x, A, B, D)
    ref = (gamma * r).reshape(1, -1, 1, 1) * (gy.float() - (S1 / n).reshape(1, -1, 1, 1)
                                              - xhat * (dgamma / n).reshape(1, -1, 1, 1))
    torch.testing.assert_close(dx.float(), ref, rtol=0, atol=2.0 ** -7 * float(ref.abs().max()))
    assert read_launches() == before
    rm, rv = torch.zeros(16), torch.ones(16)
    cuda_bn.bn_finalize(part, gamma, beta, n, 1e-5, rm, rv, 0.1)
    torch.testing.assert_close(rm, 0.1 * mean)
    torch.testing.assert_close(rv, 0.9 + 0.1 * stats[3] * n / (n - 1))
    with pytest.raises(ValueError):
        cuda_bn.bn_finalize(part, gamma, beta, n, 1e-5, rm, None)
    with pytest.raises(ValueError):
        cuda_bn.bn_finalize(part[0], gamma, beta, n, 1e-5)


@pytest.mark.parametrize("shape,blocks", [((200, 64, 112, 112), 528), ((200, 64, 56, 56), 528),
                                          ((200, 256, 14, 14), 264), ((200, 512, 7, 7), 132),
                                          ((3, 24, 5, 7), 1)],
                         ids=["stem", "layer1", "layer3", "layer4", "ragged"])
def test_sums_blocks_fit_the_rows(shape, blocks, monkeypatch):
    """On a 132-SM card the sums take whole waves of one block an SM (at
    most four) with four unrolled passes a block where the rows allow,
    and the elementwise passes one block a pass, at most 8 an SM; no
    block is left without a row."""
    monkeypatch.setattr(cuda_bn, "sm_count", lambda device: 132)
    B, C, H, W = shape
    rows = B * H * W
    dev = torch.device("cuda", 0)
    per_pass = (256 // (C // 8)) * 4
    assert cuda_bn._blocks(rows, C, dev, sums=True) == blocks
    for sums in (True, False):
        nb = cuda_bn._blocks(rows, C, dev, sums)
        assert 1 <= nb <= 132 * (4 if sums else 8) and (nb - 1) * per_pass < rows
    assert cuda_bn._blocks(rows, C, dev, sums=False) == min(-(-rows // per_pass), 1056)
