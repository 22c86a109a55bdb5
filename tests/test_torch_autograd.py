"""The port's share-space autograd (encrypted training) against the JAX
package's: the general ring conv and the Beaver combine bit for bit, the
limb GEMM's deep contraction exact, and revealed losses, gradients and SGD
steps within 5e-3 of JAX's encrypted tape and of ``jax.grad``.

Layouts differ: the JAX package is NHWC / HWIO with (in, out) linear
weights, the port NCHW / OIHW with (out, in) ones, so each side gets the
same numbers in its own layout and results are compared after moving them
back. Shares come from different random streams in the two packages, so
encrypted results are compared after reveal. Both protocols run; the fss
comparison runs the plain DCF walk on the CPU, so problems stay at a few
hundred elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.mpc import autograd as jag
from primia_tpu.mpc import beaver as jbeaver
from primia_tpu.mpc import fixed as jfixed
from primia_tpu.mpc import ring_ops as jring
from primia_tpu.mpc import shares as JS
from primia_tpu.mpc.engine import MpcContext as JaxContext
from primia_tpu.mpc.engine import encode_and_share as jax_share_tree
from primia_tpu.mpc.engine import reveal_and_decode as jax_reveal
from primia_tpu_torch.mpc import autograd as ag
from primia_tpu_torch.mpc import beaver, fixed, ring_ops
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.engine import MpcContext, encode_and_share, reveal_and_decode
from primia_tpu_torch.mpc.shares import AShare

TOL = 5e-3


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ring(rng, shape):
    return rng.integers(-(1 << 63), (1 << 63) - 1, shape, dtype=np.int64, endpoint=True)


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


def _oihw(w):
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------ the conv VJPs' convs

def _vjp_convs(stride, padding=1, kh=3):
    """The two gradient convs of ``conv2d`` on an 8x8 input (2 channels
    in, 3 out), in each package's layout: (jax f_gx, port f_gx, jax f_gw,
    port f_gw, output size); JAX's as written in its ``conv2d`` VJP."""
    H = 8
    rem = (H + 2 * padding - kh) % stride
    lo, hi = kh - 1 - padding, kh - 1 - padding + rem

    def j_gx(gd, wd):
        return jring.ring_conv_general(gd, jnp.swapaxes(wd[::-1, ::-1], 2, 3),
                                       padding=((lo, hi), (lo, hi)),
                                       lhs_dilation=(stride, stride))

    def j_gw(xd, gd):
        r = jring.ring_conv_general(jnp.transpose(xd, (3, 1, 2, 0)),
                                    jnp.transpose(gd, (1, 2, 0, 3)),
                                    padding=((padding, padding),) * 2,
                                    rhs_dilation=(stride, stride))
        return jnp.transpose(r, (1, 2, 0, 3))[:kh, :kh]

    ho = (H + 2 * padding - kh) // stride + 1
    p_gx, p_gw = ag.conv_vjp_fns((2, 2, H, H), (3, 2, kh, kh), stride, padding)
    return j_gx, p_gx, j_gw, p_gw, ho


@pytest.mark.parametrize("stride", [1, 2])
def test_ring_conv_general_matches_jax_at_the_vjp_shapes(stride):
    """Both gradient convs, bit for bit, on the CPU's int64 conv and on the
    card's limb form (run here on the CPU); stride 2 leaves a remainder."""
    j_gx, p_gx, j_gw, p_gw, ho = _vjp_convs(stride)
    rng = np.random.default_rng(stride)
    g = _ring(rng, (2, ho, ho, 3))  # NHWC output gradient, 3 channels out
    w = _ring(rng, (3, 3, 2, 3))  # HWIO, 2 channels in
    x = _ring(rng, (2, 8, 8, 2))
    want_gx = _nchw(_np(j_gx(jnp.asarray(g), jnp.asarray(w))))
    want_gw = _oihw(_np(j_gw(jnp.asarray(x), jnp.asarray(g))))
    tg, tw, tx = _t(_nchw(g)), _t(_oihw(w)), _t(_nchw(x))
    assert want_gx.shape == (2, 2, 8, 8) and want_gw.shape == (3, 2, 3, 3)
    np.testing.assert_array_equal(p_gx(tg, tw).numpy(), want_gx)
    np.testing.assert_array_equal(p_gw(tx, tg).numpy(), want_gw)
    lo, hi = 1, 1 + (7 % stride)
    limb = ring_ops.limb_conv_general(tg, tw.flip(2, 3).transpose(0, 1),
                                      padding=((lo, hi), (lo, hi)),
                                      lhs_dilation=(stride, stride))
    np.testing.assert_array_equal(limb.numpy(), want_gx)
    limb = ring_ops.limb_conv_general(tx.transpose(0, 1), tg.transpose(0, 1),
                                      padding=((1, 1), (1, 1)), rhs_dilation=(stride, stride))
    np.testing.assert_array_equal(limb.transpose(0, 1)[..., :3, :3].numpy(), want_gw)


@pytest.mark.parametrize("stride", [1, 2])
def test_bilinear_with_one_explicit_triple_matches_jax(stride):
    """The general online combine on the weight gradient's conv, from one
    triple and one pair of sharings handed to both packages."""
    _, _, j_gw, p_gw, ho = _vjp_convs(stride)
    rng = np.random.default_rng(10 + stride)
    xs, gs = (2, 2, 8, 8, 2), (2, 2, ho, ho, 3)
    x, a = _ring(rng, xs), _ring(rng, xs)
    g, b = _ring(rng, gs), _ring(rng, gs)
    a_plain, b_plain = a.sum(0), b.sum(0)  # wraps: ring sums
    c_plain = _np(j_gw(jnp.asarray(a_plain), jnp.asarray(b_plain)))
    c1 = _ring(rng, c_plain.shape)
    c = np.stack([c_plain - c1, c1])
    jt = jbeaver.Triple(*(JS.AShare(jnp.asarray(v)) for v in (a, b, c)))
    want = _np(jbeaver.bilinear(j_gw, JS.AShare(jnp.asarray(x)), JS.AShare(jnp.asarray(g)),
                                jt).data)
    to_port = lambda v: _t(np.moveaxis(v, -1, 2))  # noqa: E731  (2, B, H, W, C) -> NCHW
    pt = beaver.Triple(AShare(to_port(a)), AShare(to_port(b)),
                       AShare(_t(c.transpose(0, 4, 3, 1, 2))))
    got = beaver.bilinear(p_gw, AShare(to_port(x)), AShare(to_port(g)), pt)
    np.testing.assert_array_equal(got.data.numpy(), want.transpose(0, 4, 3, 1, 2))


def test_limb_mm_contracts_past_2_14_exactly():
    """A weight gradient's depth (64 x 28 x 28 = 50,176) runs in chunks:
    the limb GEMM equals int64 ``@``, which wraps mod 2^64."""
    rng = np.random.default_rng(3)
    a, b = _t(_ring(rng, (17, 50_176))), _t(_ring(rng, (50_176, 8)))
    assert torch.equal(ring_ops.limb_matmul(a, b), a @ b)


# ---------------------------------------------------------------- the MLP

def _jax_mlp(ctx, p, xs, ys):
    h = jag.relu(ctx, jag.linear(ctx, jag.Var(xs), p["w1"], p["b1"]))
    return jag.mse_loss(ctx, jag.linear(ctx, h, p["w2"], p["b2"]), ys)


def _port_mlp(ctx, p, xs, ys):
    h = ag.relu(ctx, ag.linear(ctx, ag.Var(xs), p["w1"], p["b1"]))
    return ag.mse_loss(ctx, ag.linear(ctx, h, p["w2"], p["b2"]), ys)


def _jax_mlp_plain(p, x, y):
    h = jax.nn.relu(x @ p["w1"] + p["b1"])
    return jnp.mean((h @ p["w2"] + p["b2"] - y) ** 2)


def _mlp_problem():
    """tests/test_encrypted_training.py's MLP: 4 -> 8 -> 3 on 6 examples."""
    rng = np.random.default_rng(0)
    params = {"w1": rng.normal(0, 0.5, (4, 8)), "b1": rng.normal(0, 0.1, (8,)),
              "w2": rng.normal(0, 0.5, (8, 3)), "b2": rng.normal(0, 0.1, (3,))}
    return params, rng.normal(0, 1, (6, 4)), rng.normal(0, 1, (6, 3))


def _port_layout(params):
    """(in, out) linear weights -> (out, in)."""
    return {k: _t(v.T if k.startswith("w") else v) for k, v in params.items()}


def _from_port(k, v):
    v = v.numpy()
    return v.T if k.startswith("w") else v


def _jax_encrypted(params, x, y, protocol, seed):
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    ctx = JaxContext(k1, protocol=protocol)
    ps = jax_share_tree(k2, {k: jnp.asarray(v, jnp.float64) for k, v in params.items()})
    xs = JS.share(k3, jfixed.encode(jnp.asarray(x)))
    ys = JS.share(k4, jfixed.encode(jnp.asarray(y)))
    return ctx, ps, xs, ys


def _jax_value_and_grad(forward, params, x, y, protocol, seed):
    """JAX's encrypted loss share and gradient shares, jitted: eager, the
    protocols are thousands of small dispatches."""
    def run(p, xv, yv):
        ctx, ps, xs, ys = _jax_encrypted(p, xv, yv, protocol, seed)
        return jag.value_and_grad(forward)(ctx, ps, xs, ys)

    return jax.jit(run)(params, x, y)


def _port_encrypted(params, x, y, protocol, seed):
    g = torch.Generator().manual_seed(seed)
    ctx = MpcContext(g, protocol=protocol)
    ps = encode_and_share(g, params)
    return ctx, ps, S.share(g, fixed.encode(_t(x))), S.share(g, fixed.encode(_t(y)))


@pytest.mark.parametrize("protocol", ["snn", "fss"])
def test_mlp_loss_and_gradients_match_jax(protocol):
    params, x, y = _mlp_problem()
    j_loss, j_grads = _jax_value_and_grad(_jax_mlp, params, x, y, protocol, 1)
    ref_loss, ref_grads = jax.value_and_grad(_jax_mlp_plain)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), jnp.asarray(y))

    ctx, ps, xs, ys = _port_encrypted(_port_layout(params), x, y, protocol, 1)
    loss, grads = ag.value_and_grad(_port_mlp)(ctx, ps, xs, ys)
    got = float(reveal_and_decode(loss))
    assert abs(got - float(jax_reveal(j_loss))) < TOL
    assert abs(got - float(ref_loss)) < TOL
    for k in params:
        g = _from_port(k, reveal_and_decode(grads[k]))
        np.testing.assert_allclose(g, np.asarray(jax_reveal(j_grads[k])), atol=TOL, err_msg=k)
        np.testing.assert_allclose(g, np.asarray(ref_grads[k]), atol=TOL, err_msg=k)
    # one party's gradient share is not the gradient
    one = grads["w1"].data[0].double().numpy()
    assert not np.allclose(one, _from_port("w1", reveal_and_decode(grads["w1"])).T * 2**16,
                           atol=1e3)


def test_five_sgd_steps_match_jax_encrypted_and_plain_steps():
    params, x, y = _mlp_problem()
    _, jps, jxs, jys = _jax_encrypted(params, x, y, "snn", 4)
    ctx, ps, xs, ys = _port_encrypted(_port_layout(params), x, y, "snn", 4)
    pp = {k: jnp.asarray(v) for k, v in params.items()}

    @jax.jit
    def jax_step(key, jps):
        _, jg = jag.value_and_grad(_jax_mlp)(JaxContext(key), jps, jxs, jys)
        return {k: jag.sgd_update(v, jg[k], lr=0.1) for k, v in jps.items()}

    p_vag = ag.value_and_grad(_port_mlp)
    gfn = jax.jit(jax.grad(_jax_mlp_plain))
    losses = []
    for i in range(5):
        jps = jax_step(jax.random.PRNGKey(100 + i), jps)
        loss, g = p_vag(ctx, ps, xs, ys)
        losses.append(float(reveal_and_decode(loss)))
        ps = {k: ag.sgd_update(v, g[k], lr=0.1) for k, v in ps.items()}
        pg = gfn(pp, jnp.asarray(x), jnp.asarray(y))
        pp = {k: v - 0.1 * pg[k] for k, v in pp.items()}
    for k in params:
        got = _from_port(k, reveal_and_decode(ps[k]))
        np.testing.assert_allclose(got, np.asarray(jax_reveal(jps[k])), atol=TOL, err_msg=k)
        np.testing.assert_allclose(got, np.asarray(pp[k]), atol=TOL, err_msg=k)
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------- the conv net

def _jax_conv(ctx, p, xs, ys, stride):
    h = jag.conv2d(ctx, jag.Var(xs), p["w"], stride=stride, padding=1)
    h = jag.avg_pool(ctx, jag.relu(ctx, jag.bias_add(h, p["cb"])), 2)
    return jag.mse_loss(ctx, jag.linear(ctx, jag.flatten(h), p["wf"], p["bf"]), ys)


def _port_conv(ctx, p, xs, ys, stride):
    h = ag.conv2d(ctx, ag.Var(xs), p["w"], stride=stride, padding=1)
    h = ag.avg_pool(ctx, ag.relu(ctx, ag.bias_add(h, p["cb"])), 2)
    return ag.mse_loss(ctx, ag.linear(ctx, ag.flatten(h), p["wf"], p["bf"]), ys)


def _jax_conv_plain(p, x, y, stride):
    h = jax.lax.conv_general_dilated(x, p["w"], (stride, stride), ((1, 1), (1, 1)),
                                     dimension_numbers=("NHWC", "HWIO", "NHWC")) + p["cb"]
    h = jax.nn.relu(h)
    B, H, W, C = h.shape
    h = h.reshape(B, H // 2, 2, W // 2, 2, C).mean((2, 4))
    return jnp.mean((h.reshape(B, -1) @ p["wf"] + p["bf"] - y) ** 2)


@pytest.mark.parametrize("protocol,stride", [("snn", 1), ("snn", 2), ("fss", 2)])
def test_conv_net_loss_and_gradients_match_jax(protocol, stride):
    """tests/test_encrypted_training.py's conv net: conv 3x3 / p1 (1 -> 2
    channels) with a bias, ReLU, avg pool 2, linear; stride 2 drops a
    partial window (the VJPs' remainder)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 8, 8, 1))
    ho = (8 + 2 - 3) // stride + 1
    hp = ho // 2
    params = {"w": rng.normal(0, 0.4, (3, 3, 1, 2)), "cb": rng.normal(0, 0.1, (2,)),
              "wf": rng.normal(0, 0.4, (hp * hp * 2, 3)), "bf": rng.normal(0, 0.1, (3,))}
    y = rng.normal(0, 1, (2, 3))

    def wf_to_port(wf):  # rows (h, w, c) -> columns (c, h, w)
        return wf.reshape(hp, hp, 2, 3).transpose(3, 2, 0, 1).reshape(3, -1)

    def wf_from_port(wf):
        return wf.reshape(3, 2, hp, hp).transpose(2, 3, 1, 0).reshape(-1, 3)

    j_loss, j_grads = _jax_value_and_grad(lambda c, p, a, b: _jax_conv(c, p, a, b, stride),
                                          params, x, y, protocol, 6)
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: _jax_conv_plain(p, jnp.asarray(x), jnp.asarray(y), stride))(
        {k: jnp.asarray(v) for k, v in params.items()})

    port_params = {"w": _t(_oihw(params["w"])), "cb": _t(params["cb"]),
                   "wf": _t(wf_to_port(params["wf"])), "bf": _t(params["bf"])}
    ctx, ps, xs, ys = _port_encrypted(port_params, _nchw(x), y, protocol, 6)
    loss, grads = ag.value_and_grad(
        lambda c, p, a, b: _port_conv(c, p, a, b, stride))(ctx, ps, xs, ys)
    got = float(reveal_and_decode(loss))
    assert abs(got - float(jax_reveal(j_loss))) < TOL
    assert abs(got - float(ref_loss)) < TOL
    back = {"w": lambda v: v.transpose(2, 3, 1, 0), "cb": lambda v: v, "wf": wf_from_port,
            "bf": lambda v: v}
    for k in params:
        g = back[k](reveal_and_decode(grads[k]).numpy())
        np.testing.assert_allclose(g, np.asarray(jax_reveal(j_grads[k])), atol=TOL, err_msg=k)
        np.testing.assert_allclose(g, np.asarray(ref_grads[k]), atol=TOL, err_msg=k)


def test_elementwise_mul_add_sub_grads():
    g = torch.Generator().manual_seed(7)
    ctx = MpcContext(g)
    xv, yv = torch.tensor([1.5, -2.0, 0.5]), torch.tensor([3.0, 1.0, -4.0])
    x = ag.Var(S.share(g, fixed.encode(xv)))
    y = ag.Var(S.share(g, fixed.encode(yv)))
    z = ag.sub(ag.add(ag.mul(ctx, x, y), x), y)  # x y + x - y
    np.testing.assert_allclose(reveal_and_decode(z.value).numpy(), (xv * yv + xv - yv).numpy(),
                               atol=1e-3)
    grads = ag.backward(z, S.share(g, fixed.encode(torch.ones(3))))
    np.testing.assert_allclose(reveal_and_decode(grads[id(x)]).numpy(), (yv + 1).numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(reveal_and_decode(grads[id(y)]).numpy(), (xv - 1).numpy(),
                               atol=1e-3)


def test_avg_pool_backward_zero_fills_a_partial_window():
    """A 5x5 map under a 2x2 pool: the last row and column get no
    gradient, and the gradient keeps the input's shape."""
    g = torch.Generator().manual_seed(8)
    ctx = MpcContext(g)
    v = torch.arange(50, dtype=torch.float64).reshape(1, 2, 5, 5) / 10
    x = ag.Var(S.share(g, fixed.encode(v)))
    out = ag.avg_pool(ctx, x, 2)
    np.testing.assert_allclose(reveal_and_decode(out.value).numpy(),
                               torch.nn.functional.avg_pool2d(v, 2).numpy(), atol=1e-3)
    (gx,) = out.vjp(S.share(g, fixed.encode(torch.ones(1, 2, 2, 2))))
    want = torch.zeros(1, 2, 5, 5)
    want[..., :4, :4] = 0.25
    np.testing.assert_allclose(reveal_and_decode(gx).numpy(), want.numpy(), atol=1e-4)
