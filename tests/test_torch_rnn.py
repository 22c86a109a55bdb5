"""The port's RNN library (``nn/rnn.py``) against the JAX package's: the
parameters carried across from JAX's ``rnn_init``, the plain RNN, GRU and
LSTM within 1e-5 of JAX (two layers, both directions, ``batch_first``),
and encrypted forwards under both protocols within 5e-3 of plain, the
limit of ``tests/test_rnn.py``.

JAX's layers keep (in, out) weights, the port's PyTorch's (out, in):
``nn/jax_params.py:rnn_from_jax`` moves them. A layer past the first of a
bidirectional stack reads only its own direction in both packages, so
two layers and both directions are held apart, as JAX's own tests hold
them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.nn import rnn as JR
from primia_tpu.nn.core import PLAIN as JPLAIN
from primia_tpu_torch.mpc import engine as E
from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.nn import rnn as R
from primia_tpu_torch.nn.jax_params import rnn_from_jax

KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(kind, F, H, layers=1, bidirectional=False, key=KEY):
    return JR.rnn_init(key, F, H, num_layers=layers, kind=kind, bidirectional=bidirectional,
                       dtype=jnp.float64)


def _finals(finals):
    """Final states as one array: (layers x directions[, 2], B, H)."""
    return np.stack([np.stack([np.asarray(a) for a in f]) if isinstance(f, tuple)
                     else np.asarray(f) for f in finals])


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
def test_parameters_carry_across_from_jax_rnn_init(kind):
    jp = _jax_params(kind, 4, 6, layers=2, bidirectional=True)
    pp = rnn_from_jax(jp)
    ours = R.rnn_init(torch.Generator().manual_seed(0), 4, 6, num_layers=2, kind=kind,
                      bidirectional=True)
    for d in ("fwd", "bwd"):
        assert len(pp[d]) == len(jp[d]) == len(ours[d]) == 2
        for jc, pc, oc in zip(jp[d], pp[d], ours[d]):
            assert set(jc) == set(pc) == set(oc)
            for k, v in jc.items():
                v = np.asarray(v)
                want = v.T if v.ndim == 2 else v
                np.testing.assert_array_equal(pc[k].numpy(), want.astype(np.float32))
                assert oc[k].shape == pc[k].shape
                bound = 1 / np.sqrt(6)
                assert float(oc[k].abs().max()) <= bound
    if kind == "lstm":  # the forget-gate chunk starts at 1 / hidden in both
        for c in (pp["fwd"][0], ours["fwd"][0]):
            np.testing.assert_allclose(c["bxh"][6:12].numpy(), 1 / 6, rtol=1e-6)


@pytest.mark.parametrize("kind", ["rnn", "gru", "lstm"])
@pytest.mark.parametrize("layers,bidirectional,batch_first",
                         [(2, False, False), (1, True, False), (2, False, True)])
def test_plain_forward_matches_jax(kind, layers, bidirectional, batch_first):
    T, B, F, H = 5, 3, 4, 6
    jp = _jax_params(kind, F, H, layers, bidirectional)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, T, F) if batch_first else (T, B, F))
    want, want_f = JR.rnn_apply(JPLAIN, jp, jnp.asarray(x), kind=kind, batch_first=batch_first)
    got, got_f = R.rnn_apply(R.PLAIN, rnn_from_jax(jp, torch.float64), torch.from_numpy(x),
                             kind=kind, batch_first=batch_first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_finals([tuple(t.numpy() for t in f) if isinstance(f, tuple)
                                        else f.numpy() for f in got_f]),
                               _finals(want_f), rtol=1e-5, atol=1e-5)


def test_plain_relu_rnn_and_given_states_match_jax():
    T, B, F, H = 4, 2, 3, 5
    jp = _jax_params("rnn", F, H, layers=2)
    rng = np.random.default_rng(2)
    x, h0 = rng.normal(size=(T, B, F)), rng.normal(size=(2, B, H))
    want, _ = JR.rnn_apply(JPLAIN, jp, jnp.asarray(x), [jnp.asarray(h) for h in h0],
                           kind="rnn", nonlinearity="relu")
    got, _ = R.rnn_apply(R.PLAIN, rnn_from_jax(jp, torch.float64), torch.from_numpy(x),
                         [torch.from_numpy(h) for h in h0], kind="rnn", nonlinearity="relu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _share_params(gen, params):
    return {d: [E.encode_and_share(gen, c) for c in cells] for d, cells in params.items()}


@pytest.mark.parametrize("protocol,kind", [("snn", "rnn"), ("snn", "gru"), ("snn", "lstm"),
                                           ("fss", "lstm")])
def test_encrypted_forward_matches_plain(protocol, kind):
    """tests/test_rnn.py's toy sequence, two layers, at its limit (5e-3);
    one party's output share looks nothing like the output."""
    T, B, F, H = 3, 2, 4, 5
    params = rnn_from_jax(_jax_params(kind, F, H, layers=2), torch.float64)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(T, B, F)))
    want, want_f = R.rnn_apply(R.PLAIN, params, x, kind=kind)
    g = torch.Generator().manual_seed(5)
    eng = E.MpcEngine(E.MpcContext(g, protocol=protocol))
    out, finals = R.rnn_apply(eng, _share_params(g, params), S.share(g, fixed.encode(x)),
                              kind=kind)
    np.testing.assert_allclose(E.reveal_and_decode(out).numpy(), want.numpy(), atol=5e-3)
    last = finals[-1][0] if kind == "lstm" else finals[-1]
    want_last = want_f[-1][0] if kind == "lstm" else want_f[-1]
    np.testing.assert_allclose(E.reveal_and_decode(last).numpy(), want_last.numpy(), atol=5e-3)
    assert out.data[0].abs().min() > 1e6


def test_encrypted_bidirectional_batch_first_gru_matches_plain():
    B, T, F, H = 2, 3, 2, 4
    params = rnn_from_jax(_jax_params("gru", F, H, bidirectional=True), torch.float64)
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(B, T, F)))
    want, _ = R.rnn_apply(R.PLAIN, params, x, kind="gru", batch_first=True)
    g = torch.Generator().manual_seed(7)
    eng = E.MpcEngine(E.MpcContext(g, protocol="snn"))
    out, _ = R.rnn_apply(eng, _share_params(g, params), S.share(g, fixed.encode(x)),
                         kind="gru", batch_first=True)
    assert out.shape == (B, T, 2 * H)
    np.testing.assert_allclose(E.reveal_and_decode(out).numpy(), want.numpy(), atol=5e-3)


def test_engine_structural_ops():
    g = torch.Generator().manual_seed(8)
    eng = E.MpcEngine(E.MpcContext(g))
    v = torch.arange(2 * 3 * 8, dtype=torch.int64).reshape(2, 3, 8)
    x = S.share(g, v)
    parts = eng.split_last(x, 4)
    assert [S.reconstruct(p).tolist() for p in parts] == [t.tolist() for t in v.chunk(4, -1)]
    assert torch.equal(S.reconstruct(eng.concat_last(parts)), v)
    assert torch.equal(S.reconstruct(eng.time_slice(x, 1)), v[1])
    assert torch.equal(S.reconstruct(eng.stack_time([x, x])), torch.stack([v, v]))
    assert torch.equal(S.reconstruct(eng.swap_time_batch(x)), v.transpose(0, 1))
    assert eng.zeros((3, 4), x).data.shape == (2, 3, 4)
    with pytest.raises(ValueError):
        eng.split_last(x, 3)
