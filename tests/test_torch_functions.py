"""The port's share-space function library (``mpc/functions.py``) against
the JAX package's.

The same numpy inputs go through both packages' functions under SecureNN
(and the FSS comparison where ``tests/test_functions.py`` runs it); each
revealed output is held to the JAX function's and to numpy's within the
atol (and rtol) of the JAX package's own test of it, named in each case.
The dealers' draws differ, so the comparison is after reveal. The JAX
functions run eagerly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.mpc import engine as JE
from primia_tpu.mpc import functions as JF
from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import functions as F
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.engine import MpcContext, MpcEngine, reveal_and_decode


@pytest.fixture(autouse=True)
def _no_debug_domains(monkeypatch):
    monkeypatch.delenv("PRIMIA_MPC_DEBUG_DOMAINS", raising=False)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Share-space code is thousands of small integer ops: under the
    suite's parallel workers, intra-op threads only wait on each other
    (tens of times slower than one thread), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jctx(protocol="snn", debug=False):
    return JE.MpcContext(jax.random.PRNGKey(11), protocol=protocol, debug_domains=debug)


def _pctx(protocol="snn", debug=False):
    return MpcContext(torch.Generator().manual_seed(11), protocol=protocol, debug_domains=debug)


def _jenc(x):
    return JE.encode_and_share(jax.random.PRNGKey(5), jnp.asarray(x, jnp.float64))


def _penc(x, seed=5):
    return S.share(torch.Generator().manual_seed(seed), fixed.encode(torch.from_numpy(
        np.asarray(x, np.float64))))


def _jdec(sh):
    return np.asarray(JE.reveal_and_decode(sh))


def _pdec(sh):
    return reveal_and_decode(sh).numpy()


def _both(fn, x, *args, protocol="snn", **kw):
    """fn's revealed output from each package."""
    port = _pdec(getattr(F, fn)(_pctx(protocol), _penc(x), *args, **kw))
    ref = _jdec(getattr(JF, fn)(_jctx(protocol), _jenc(x), *args, **kw))
    return port, ref


def _close(port, jax_out, want, atol, rtol=0.0):
    assert port.shape == np.shape(want) and np.isfinite(port).all()
    np.testing.assert_allclose(port, jax_out, atol=atol, rtol=rtol)
    np.testing.assert_allclose(port, want, atol=atol, rtol=rtol)


# (function, input, args, kwargs, numpy reference, atol, rtol): test_functions.py's cases
X_EXP = np.array([-4.0, -1.2, 0.0, 0.1, 0.5, 1.0, 2.0, 3.5, 7.9])
X_SIG = np.array([-7.5, -4.0, -1.2, 0.0, 0.1, 0.5, 2.0, 3.5, 7.9])
X_TANH = np.array([-9.0, -6.5, -2.0, -0.3, 0.0, 0.7, 3.0, 6.2, 11.0])
X_POW = np.array([0.5, 1.5, -2.0, 3.0])
X_SQRT = np.array([0.05, 0.25, 1.0, 2.0, 9.0, 100.0])
CASES = {
    "exp": ("exp", X_EXP, (), {}, (1 + X_EXP / 256) ** 256, 1e-3, 5e-3),
    "log": ("log", np.array([0.05, 0.2, 1.0, 2.718281828, 10.0, 50.0]), (), {},
            np.log([0.05, 0.2, 1.0, 2.718281828, 10.0, 50.0]), 5e-2, 0.0),
    "reciprocal_nr_neg": ("reciprocal", -np.array([0.05, 0.2, 1.0, 2.0, 5.0, 20.0, 100.0]), (),
                          {}, -1 / np.array([0.05, 0.2, 1.0, 2.0, 5.0, 20.0, 100.0]), None, 0.0),
    "reciprocal_newton_is_rsqrt": ("reciprocal", np.array([0.25, 1.0, 4.0, 17.0]), (),
                                   {"method": "newton"}, 1 / np.sqrt([0.25, 1.0, 4.0, 17.0]),
                                   5e-3, 0.0),
    "reciprocal_log": ("reciprocal", np.array([0.5, 2.0, 8.0, -3.0]), (), {"method": "log"},
                       1 / np.array([0.5, 2.0, 8.0, -3.0]), 8e-2, 0.0),
    "inverse_sqrt": ("inverse_sqrt", X_SQRT, (), {}, 1 / np.sqrt(X_SQRT), 5e-3, 0.0),
    "sqrt": ("sqrt", X_SQRT, (), {}, np.sqrt(X_SQRT), 5e-3, 5e-3),
    "pow0": ("pow", X_POW, (0,), {}, np.ones(4), 1e-7, 0.0),
    "pow1": ("pow", X_POW, (1,), {}, X_POW, 1e-4, 1e-3),
    "pow2": ("pow", X_POW, (2,), {}, X_POW ** 2, 1e-3, 1e-3),
    "pow3": ("pow", X_POW, (3,), {}, X_POW ** 3, 1e-2, 1e-3),
    "pow7": ("pow", X_POW, (7,), {}, X_POW ** 7, 0.3, 1e-3),
    "inverse": ("inverse", np.array([[2.0, 0.3], [0.5, 1.5]]), (), {"iterations": 14},
                np.linalg.inv([[2.0, 0.3], [0.5, 1.5]]), 1e-3, 0.0),
    "sigmoid_chebyshev": ("sigmoid", X_SIG, ("chebyshev",), {}, 1 / (1 + np.exp(-X_SIG)),
                          2e-3, 0.0),
    "sigmoid_exp": ("sigmoid", X_SIG, ("exp",), {}, 1 / (1 + np.exp(-X_SIG)), 5e-3, 0.0),
    "sigmoid_maclaurin": ("sigmoid", X_SIG, ("maclaurin",), {},
                          0.5 + 1.91204779e-1 * X_SIG - 4.58667307e-3 * X_SIG ** 3
                          + 4.20690803e-5 * X_SIG ** 5, 2e-3, 0.0),
    "tanh_chebyshev": ("tanh", X_TANH, (), {}, np.tanh(X_TANH), 2e-3, 0.0),
    "tanh_sigmoid": ("tanh", np.array([-2.0, -0.5, 0.0, 0.5, 2.0]), (), {"method": "sigmoid"},
                     np.tanh([-2.0, -0.5, 0.0, 0.5, 2.0]), 1e-2, 0.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_jax_and_numpy(case):
    fn, x, args, kw, want, atol, rtol = CASES[case]
    port, ref = _both(fn, x, *args, **kw)
    if atol is None:  # test_reciprocal_nr_both_signs: (1/x) x within 5e-3 of 1
        np.testing.assert_allclose(port * x, 1.0, atol=5e-3)
        np.testing.assert_allclose(port * x, ref * x, atol=5e-3)
        return
    _close(port, ref, want, atol, rtol)


def test_reciprocal_nr_positive_and_the_fss_comparison():
    """``nr`` on positive x under both protocols."""
    x = np.array([0.05, 0.2, 1.0, 2.0, 5.0, 20.0, 100.0])
    for protocol in ("snn", "fss"):
        port, ref = _both("reciprocal", x, protocol=protocol)
        np.testing.assert_allclose(port * x, 1.0, atol=5e-3)
        np.testing.assert_allclose(port * x, ref * x, atol=5e-3)


def test_tanh_clamps_under_fss():
    """Outside [-6, 6] tanh is +-1 exactly (within 1e-4), under FSS as well."""
    port, ref = _both("tanh", X_TANH, protocol="fss")
    _close(port, ref, np.tanh(X_TANH), 2e-3)
    np.testing.assert_allclose(port[[0, 1]], -1.0, atol=1e-4)
    np.testing.assert_allclose(port[[7, 8]], 1.0, atol=1e-4)


def test_argmax_argmin_max_min():
    """argmax and max against JAX and numpy; argmin and min (argmax and max
    of -x in both packages) against numpy."""
    a = np.array([[0.3, 1.0, -0.5, 2.0], [5.0, -1.0, 0.0, 4.9]])
    for fn, kw, want, atol in (("argmax", {"axis": 1}, a.argmax(1), 1e-9),
                               ("max", {"axis": 1}, a.max(1), 1e-4),
                               ("argmax", {}, a.argmax(), 1e-9),
                               ("max", {}, a.max(), 1e-4)):
        port, ref = _both(fn, a, **kw)
        _close(port, ref, want, atol)
    for fn, want, atol in (("argmin", a.argmin(1), 1e-9), ("min", a.min(1), 1e-4)):
        port = _pdec(getattr(F, fn)(_pctx(), _penc(a), axis=1))
        np.testing.assert_allclose(port, want, atol=atol, rtol=0)
    oh = F.argmax(_pctx(), _penc(a), axis=1, one_hot=True)
    np.testing.assert_array_equal(S.reconstruct(oh).numpy(), np.eye(4)[a.argmax(1)])
    ties, _ = _both("argmax", np.array([1.0, 3.0, 3.0, 0.0]))
    assert ties == 1 + 2  # tied maxima sum their indices, as the reference


def test_maxpool_and_deriv():
    a = np.array([[0.5, -1.0], [3.25, 0.0]])
    mx, idx = F.maxpool(_pctx(), _penc(a))
    assert abs(float(_pdec(mx)) - 3.25) < 1e-4 and float(_pdec(idx)) == 2
    np.testing.assert_array_equal(S.reconstruct(F.maxpool_deriv(_pctx(), _penc(a))).numpy(),
                                  [[0, 0], [1, 0]])


def test_mean_var():
    a = np.random.default_rng(3).normal(size=(3, 8))
    for kw, want, atol in (({"axis": 1}, a.mean(1), 1e-4),):
        port, ref = _both("mean", a, **kw)
        _close(port, ref, want, atol)
    for kw, want in (({"axis": 1}, a.var(1)), ({"axis": 1, "unbiased": True}, a.var(1, ddof=1)),
                     ({}, a.var())):
        port, ref = _both("var", a, **kw)
        _close(port, ref, want, 1e-3)


@pytest.mark.parametrize("n", [1, 8, 24, 49, 784, 25_088, 3 ** 9])
def test_div_public_int_is_exact_to_a_few_ulps(n):
    """The port's division by a public count (its deviation from JAX's
    ``mul_public(1 / n)``): within 4 units of 2^-16 of x / n at every n,
    where ``encode(1 / n)`` at 16 bits is 15% off at n = 25,088."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 3, 50) * n
    got = _pdec(F.div_public_int(_pctx(), _penc(x), n))
    np.testing.assert_allclose(got, x / n, atol=4 * 2.0 ** -16, rtol=0)


def test_private_division():
    x, y = np.array([1.0, -2.0, 0.5, 4.0]), np.array([2.5, 0.8, -1.6, 3.0])
    port = _pdec(F.div(_pctx(), _penc(x), _penc(y, 6)))
    ref = _jdec(JF.div(_jctx(), _jenc(x), JE.encode_and_share(jax.random.PRNGKey(6),
                                                              jnp.asarray(y))))
    _close(port, ref, x / y, 5e-3)


def test_div_securenn_backend():
    """Exact floor division of the scaled numerator, signs put back
    (tests/test_securenn_extra.py: within 2e-4)."""
    x = np.array([1.0, -2.5, 0.5, 4.0, -3.0])
    y = np.array([2.5, 0.8, -1.6, 3.0, -0.7])
    port = _pdec(F.div(_pctx(), _penc(x), _penc(y, 6), "securenn"))
    ref = _jdec(JF.div(_jctx(), _jenc(x), JE.encode_and_share(jax.random.PRNGKey(6),
                                                              jnp.asarray(y)), "securenn"))
    _close(port, ref, x / y, 2e-4)


def test_private_batch_norm_matches_plaintext():
    """The engine's batch norm with secret statistics (NCHW here, NHWC in
    JAX), within the JAX test's 5e-3."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 4, 4, 3))
    mean, var = rng.normal(size=3) * 0.3, rng.uniform(0.25, 4.0, size=3)
    w, b = rng.normal(size=3) * 0.5 + 1.0, rng.normal(size=3) * 0.1
    want = (x - mean) / np.sqrt(var + 1e-5) * w + b
    ref = _jdec(JE.MpcEngine(_jctx()).batch_norm(*(_jenc(v) for v in (x, mean, var, w, b))))
    E = MpcEngine(_pctx())
    port = _pdec(E.batch_norm(_penc(x.transpose(0, 3, 1, 2)), *(
        _penc(v, 6 + i) for i, v in enumerate((mean, var, w, b))))).transpose(0, 2, 3, 1)
    _close(port, ref, want, 5e-3)


# ------------------------------------------------------------ domains

@pytest.mark.parametrize("fn,x,kw", [
    ("log", [1e-5], {}), ("log", [500.0], {}), ("reciprocal", [0.001], {}),
    ("reciprocal", [150.0], {}), ("exp", [9.0], {}), ("exp", [-300.0], {}),
    ("inverse_sqrt", [1e-3], {}), ("inverse_sqrt", [300.0], {})],
    ids=["log_lo", "log_hi", "reciprocal_lo", "reciprocal_hi", "exp_hi", "exp_lo",
         "inverse_sqrt_lo", "inverse_sqrt_hi"])
def test_debug_domains_raise_outside_the_domain(fn, x, kw, monkeypatch):
    """``PRIMIA_MPC_DEBUG_DOMAINS=1`` reveals the operand and raises (the
    JAX package's guard; ``inverse_sqrt``'s is the port's own); by default
    nothing is checked."""
    monkeypatch.setenv("PRIMIA_MPC_DEBUG_DOMAINS", "1")
    ctx = MpcContext(torch.Generator().manual_seed(11))
    assert ctx.debug_domains
    with pytest.raises(FloatingPointError, match="approximation domain"):
        getattr(F, fn)(ctx, _penc(np.array(x)), **kw)
    monkeypatch.delenv("PRIMIA_MPC_DEBUG_DOMAINS")
    assert np.isfinite(_pdec(getattr(F, fn)(_pctx(), _penc(np.array(x)), **kw))).all()


def test_debug_domains_pass_at_the_edges():
    ok = _pdec(F.log(_pctx(debug=True), _penc(np.array([1e-3, 2e2]))))
    np.testing.assert_allclose(ok, np.log([1e-3, 2e2]), atol=0.25)
    got = _pdec(F.reciprocal(_pctx(debug=True), _penc(np.array([0.01, 100.0]))))
    np.testing.assert_allclose(got * np.array([0.01, 100.0]), 1.0, atol=5e-3)
    with pytest.raises(FloatingPointError, match="div\\[securenn\\]"):
        F.div(_pctx(debug=True), _penc(np.array([20000.0])), _penc(np.array([2.0])),
              method="securenn")


def test_function_errors():
    with pytest.raises(ValueError, match="Negative"):
        F.pow(_pctx(), _penc(X_POW), -1)
    with pytest.raises(ValueError, match="square"):
        F.inverse(_pctx(), _penc(np.zeros((2, 3))))
    with pytest.raises(ValueError, match="Invalid method"):
        F.reciprocal(_pctx(), _penc(X_POW), method="bad")
    # a batch of two matrices inverts matrix by matrix
    m = np.array([[[2.0, 0.3], [0.5, 1.5]], [[1.0, 0.0], [0.2, 0.8]]])
    np.testing.assert_allclose(_pdec(F.inverse(_pctx(), _penc(m), iterations=14)),
                               np.linalg.inv(m), atol=1e-3)
