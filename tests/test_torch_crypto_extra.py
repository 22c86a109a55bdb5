"""The port's share-space crypto library against the JAX package's: PRZS
and replicated 3-party sharing, the DPF, the comparison split into its
dealer and online phases, Paillier and BFV.

Integer code is held bit for bit. Where the JAX function draws from a
PRNG key, the test computes those draws with the JAX package and hands
them to the port: the DPF's root seeds, JAX's comparison keys, and the
ring draws of replicated sharing and PRZS (the port's ``shares.rand_ring``
replaced for the test by a queue of JAX's draws, in JAX's order). BFV
samples from ``np.random.default_rng(seed)`` in both packages, so keys and
ciphertexts agree from the same seeds. Paillier's keys are integers, and
either package decrypts the other's ciphertexts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.mpc import bfv as jbfv
from primia_tpu.mpc import compare as jcompare
from primia_tpu.mpc import dcf as jdcf
from primia_tpu.mpc import paillier as jpaillier
from primia_tpu.mpc import przs as jprzs
from primia_tpu.mpc import replicated as jrep
from primia_tpu.mpc import shares as JS
from primia_tpu_torch.mpc import bfv, compare, dcf, fixed, paillier, przs, replicated
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.dcf import DcfKeys
from primia_tpu_torch.mpc.shares import AShare


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(_np(x)))


@pytest.fixture
def jax_draws(monkeypatch):
    """A queue of JAX's ring draws that the port's ``rand_ring`` returns
    in order, each checked against the shape the port asks for."""
    queue = []

    def rand_ring(gen, shape):
        d = queue.pop(0)
        assert tuple(d.shape) == tuple(shape)
        return d

    monkeypatch.setattr(S, "rand_ring", rand_ring)
    return queue


def _share_draws(key, shape):
    """``replicated.share``'s two masks."""
    k1, k2 = jax.random.split(key)
    return [_t(JS.rand_ring(k1, shape)), _t(JS.rand_ring(k2, shape))]


def _ring_draws(key, shape, n=3):
    """The PRZS seed ring's streams."""
    return [_t(JS.rand_ring(k, shape)) for k in jprzs.setup(key, n)]


GEN = torch.Generator().manual_seed(0)  # the port's own draws are replaced


# ---------------------------------------------------------------- PRZS

def test_przs_zero_shares_match_jax(jax_draws):
    key = jax.random.PRNGKey(0)
    jax_draws += _ring_draws(key, (7, 3), 5)
    got = przs.zero_shares(przs.setup(GEN, 5), (7, 3))
    want = _np(jprzs.zero_shares(jprzs.setup(key, 5), (7, 3)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not jax_draws


def test_przs_sums_to_zero_with_random_shares():
    z = przs.zero_shares(przs.setup(torch.Generator().manual_seed(1), 3), (100,))
    assert z.shape == (3, 100)
    assert torch.equal(z.sum(0), torch.zeros(100, dtype=torch.int64))
    assert int((z != 0).sum()) > 250


# ---------------------------------------------------------- replicated

def test_replicated_share_mul_matmul_truncate_match_jax(jax_draws):
    rng = np.random.default_rng(0)
    va = jnp.asarray(rng.integers(-(2**20), 2**20, (4, 5)), jnp.int64)
    vb = jnp.asarray(rng.integers(-(2**20), 2**20, (4, 5)), jnp.int64)
    vm = jnp.asarray(rng.integers(-(2**18), 2**18, (5, 3)), jnp.int64)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)

    def both(jax_out, port_out):
        np.testing.assert_array_equal(port_out.data.numpy(), _np(jax_out.data))
        return jax_out, port_out

    for v, k in ((va, keys[0]), (vb, keys[1]), (vm, keys[2])):
        jax_draws += _share_draws(k, v.shape)
    ja, pa = both(jrep.share(keys[0], va), replicated.share(GEN, _t(va)))
    jb, pb = both(jrep.share(keys[1], vb), replicated.share(GEN, _t(vb)))
    jm, pm = both(jrep.share(keys[2], vm), replicated.share(GEN, _t(vm)))
    jax_draws += _ring_draws(keys[3], (4, 5))
    jz, pz = both(jrep.mul(keys[3], ja, jb), replicated.mul(GEN, pa, pb))
    np.testing.assert_array_equal(replicated.reconstruct(pz).numpy(), _np(va * vb))
    jax_draws += _ring_draws(keys[4], (4, 3))
    jmm, pmm = both(jrep.matmul(keys[4], ja, jm), replicated.matmul(GEN, pa, pm))
    np.testing.assert_array_equal(replicated.reconstruct(pmm).numpy(), _np(va @ vm))
    jax_draws += _ring_draws(keys[5], (4, 5))
    both(jrep.truncate(keys[5], jz), replicated.truncate(GEN, pz))
    assert not jax_draws


def test_replicated_layout_and_public_ops():
    g = torch.Generator().manual_seed(2)
    va = torch.randint(-1000, 1000, (8,))
    vb = torch.randint(-1000, 1000, (8,))
    a, b = replicated.share(g, va), replicated.share(g, vb)
    assert a.data.shape == (3, 2, 8) and a.shape == (8,)
    # party i's second slot is party i + 1's first
    assert torch.equal(a.data[:, 1], a.data[:, 0].roll(-1, 0))
    R = replicated.reconstruct
    assert torch.equal(R(replicated.add(a, b)), va + vb)
    assert torch.equal(R(replicated.sub(a, b)), va - vb)
    assert torch.equal(R(replicated.neg(a)), -va)
    assert torch.equal(R(replicated.add_public(a, 17)), va + 17)
    assert torch.equal(R(replicated.mul_public(a, -3)), va * -3)
    c = replicated.add_public(a, 17)  # the invariant holds after a public add
    assert torch.equal(c.data[:, 1], c.data[:, 0].roll(-1, 0))


def test_replicated_fixed_point_product_and_truncate_secrecy():
    g = torch.Generator().manual_seed(3)
    xf = torch.empty(32, dtype=torch.float64).uniform_(1.0, 4.0, generator=g)
    yf = torch.empty(32, dtype=torch.float64).uniform_(-4.0, 4.0, generator=g)
    x, y = replicated.share(g, fixed.encode(xf)), replicated.share(g, fixed.encode(yf))
    z = replicated.truncate(g, replicated.mul(g, x, y))
    np.testing.assert_allclose(fixed.decode(replicated.reconstruct(z)).numpy(),
                               (xf * yf).numpy(), atol=1e-3)
    sq = replicated.truncate(g, replicated.mul(g, x, x))
    for party in range(3):  # no party's pair opens the square
        pair = fixed.decode(sq.data[party, 0] + sq.data[party, 1])
        assert not np.allclose(pair.numpy(), (xf * xf).numpy(), atol=0.5)


# ---------------------------------------------------------------- DPF

@pytest.mark.parametrize("n_bits", [4, 5, 6])
def test_dpf_exhaustive_matches_jax(n_bits):
    """Keys from the same root seeds, then both parties' shares at every
    point of the domain for every key, bit for bit; they open to beta at
    alpha and to 0 elsewhere."""
    N, M = 6, 1 << n_bits
    rng = np.random.default_rng(n_bits)
    alpha = rng.integers(0, M, N).astype(np.uint32)
    alpha[:2] = [0, M - 1]
    beta = rng.integers(-(2**40), 2**40, N)
    key = jax.random.PRNGKey(n_bits)
    jk = jdcf.dpf_gen(key, jnp.asarray(alpha), jnp.asarray(beta), n_bits)
    seeds = _t(jax.random.bits(key, (2, N, 4), jnp.uint32))
    pk = dcf.dpf_gen_from_seeds(seeds, _t(alpha), _t(beta), n_bits)
    for name in ("seeds", "s_cw", "t_cw", "last_cw"):
        np.testing.assert_array_equal(getattr(pk, name).numpy(), _np(getattr(jk, name)), name)
    # every (key, point) pair as one lane
    xs = np.tile(np.arange(M, dtype=np.uint32), N)
    jrep_keys = jdcf.DpfKeys(*(jnp.repeat(a, M, axis=1 if a.ndim == 3 else 0) for a in jk))
    prep_keys = dcf.DpfKeys(*(t.repeat_interleave(M, dim=1 if t.dim() == 3 else 0)
                              for t in pk))
    shares = []
    for party in (0, 1):
        want = _np(jdcf.dpf_eval(party, jrep_keys, jnp.asarray(xs), n_bits))
        got = dcf.dpf_eval(party, prep_keys, _t(xs), n_bits).numpy()
        np.testing.assert_array_equal(got, want)
        shares.append(got)
    opened = (shares[0] + shares[1]).reshape(N, M)
    expect = np.where(np.arange(M)[None] == alpha[:, None].astype(np.int64), beta[:, None], 0)
    np.testing.assert_array_equal(opened, expect)


def test_dpf_gen_draws_its_seeds():
    g = torch.Generator().manual_seed(4)
    alpha, beta = torch.tensor([3, 9, 0]), torch.tensor([5, -7, 1])
    keys = dcf.dpf_gen(g, alpha, beta, 4)
    xs = torch.arange(16).repeat(3)
    rep = dcf.DpfKeys(keys.seeds.repeat_interleave(16, 1), keys.s_cw.repeat_interleave(16, 1),
                      keys.t_cw.repeat_interleave(16, 1), keys.last_cw.repeat_interleave(16))
    opened = (dcf.dpf_eval(0, rep, xs, 4) + dcf.dpf_eval(1, rep, xs, 4)).reshape(3, 16)
    want = torch.zeros(3, 16, dtype=torch.int64)
    want[torch.arange(3), alpha] = beta
    assert torch.equal(opened, want)


# --------------------------------------------------- the split comparison

def test_msb_of_gen_compare_equals_sign_shares():
    g = torch.Generator().manual_seed(5)
    v = torch.randint(-(1 << 30), 1 << 30, (3000,))
    v[:4] = torch.tensor([0, -1, 1, -(1 << 30)])
    x = S.share(g, v)
    fused = compare.sign_shares(torch.Generator().manual_seed(6), x)
    split = compare.msb(x, compare.gen_compare(torch.Generator().manual_seed(6), 3000))
    assert torch.equal(fused.data, split.data)
    assert torch.equal(S.reconstruct(split), (v < 0).long())


def test_msb_on_jax_keys_matches_jax_msb():
    n = 2000
    rng = np.random.default_rng(7)
    v = rng.integers(-(1 << 30), 1 << 30, n)
    r = rng.integers(-(1 << 63), (1 << 63) - 1, n, endpoint=True)
    x = np.stack([v - r, r])
    ck = jcompare.gen_compare(jax.random.PRNGKey(8), n)
    want = _np(jcompare.msb(JS.AShare(jnp.asarray(x)), ck).data)
    pk = compare.CompareKeys(AShare(_t(ck.r.data)), DcfKeys(*(_t(a) for a in ck.keys)),
                             AShare(_t(ck.c.data)))
    got = compare.msb(AShare(_t(x)), pk)
    np.testing.assert_array_equal(got.data.numpy(), want)
    np.testing.assert_array_equal(S.reconstruct(got).numpy(), (v < 0).astype(np.int64))


# ---------------------------------------------------------------- Paillier

@pytest.fixture(scope="module")
def paillier_keys():
    sk = paillier.keygen(bits=256)  # a small key: test speed only
    return sk, jpaillier.PrivateKey(jpaillier.PublicKey(sk.public.n), sk.lam, sk.mu)


def test_paillier_ciphertexts_decrypt_across_packages(paillier_keys):
    sk, jsk = paillier_keys
    rng = np.random.default_rng(9)
    a, b = rng.uniform(-50, 50, (2, 6))
    ca = paillier.encrypt(sk.public, a)
    np.testing.assert_allclose(jpaillier.decrypt(jsk, jpaillier.PaillierTensor(
        jsk.public, ca.data, ca.frac_bits)), a, atol=1e-4)
    jcb = jpaillier.encrypt(jsk.public, b)
    cb = paillier.PaillierTensor(sk.public, jcb.data, jcb.frac_bits)
    np.testing.assert_allclose(paillier.decrypt(sk, cb).numpy(), b, atol=1e-4)
    np.testing.assert_allclose(paillier.decrypt(sk, ca + cb).numpy(), a + b, atol=1e-4)
    np.testing.assert_allclose(paillier.decrypt(sk, ca - cb).numpy(), a - b, atol=1e-4)
    np.testing.assert_allclose(paillier.decrypt(sk, ca + torch.from_numpy(b)).numpy(), a + b,
                               atol=1e-4)
    np.testing.assert_allclose(paillier.decrypt(sk, ca * 7).numpy(), a * 7, atol=1e-3)
    np.testing.assert_allclose(paillier.decrypt(sk, ca * -2).numpy(), a * -2, atol=1e-3)
    # the port's homomorphic sum opens under the JAX package's key
    s = ca + cb
    np.testing.assert_allclose(jpaillier.decrypt(jsk, jpaillier.PaillierTensor(
        jsk.public, s.data, s.frac_bits)), a + b, atol=1e-4)


def test_paillier_is_randomized_and_refuses_mixed_keys(paillier_keys):
    sk, _ = paillier_keys
    c1, c2 = paillier.encrypt(sk.public, [1.0]), paillier.encrypt(sk.public, [1.0])
    assert c1.data[0] != c2.data[0]
    other = paillier.keygen(bits=256)
    with pytest.raises(ValueError):
        c1 + paillier.encrypt(other.public, [1.0])


# ---------------------------------------------------------------- BFV

@pytest.fixture(scope="module")
def bfv_pair():
    jctx = jbfv.Context()
    ctx = bfv.Context(device="cpu")
    return jctx, ctx, jbfv.KeyGenerator(jctx, seed=3).keygen(), \
        bfv.KeyGenerator(ctx, seed=3).keygen()


def test_bfv_ntt_matches_jax():
    n = 256
    p = jbfv.ntt_primes(n, 30, 1)[0]
    assert bfv.ntt_primes(n, 30, 1) == [p]
    jplan, plan = jbfv._NttPlan(n, p), bfv._NttPlan(n, p, "cpu")
    a = np.random.default_rng(10).integers(0, p, (3, n))
    np.testing.assert_array_equal(plan.fwd(_t(a)).numpy(), jplan.fwd(a))
    np.testing.assert_array_equal(plan.inv(_t(a)).numpy(), jplan.inv(a))
    np.testing.assert_array_equal(plan.inv(plan.fwd(_t(a))).numpy(), a)


def test_bfv_keys_and_relinearised_product_match_jax(bfv_pair):
    jctx, ctx, (jsk, jpk, jrk), (sk, pk, rk) = bfv_pair
    assert ctx.q_primes == jctx.q_primes and ctx.ext_primes == jctx.ext_primes
    for j, p in ((jsk.data, sk.data), (jpk.p0, pk.p0), (jpk.p1, pk.p1), (jrk.r0, rk.r0),
                 (jrk.r1, rk.r1)):
        np.testing.assert_array_equal(p.numpy(), j)
    jenc, penc = jbfv.BatchEncoder(jctx), bfv.BatchEncoder(ctx)
    u, v = np.arange(-50, 50), np.arange(100) % 7 - 3
    je, pe = jbfv.Encryptor(jctx, jpk, seed=5), bfv.Encryptor(ctx, pk, seed=5)
    ja, jb = je.encrypt(jenc.encode(u)), je.encrypt(jenc.encode(v))
    pa, pb = pe.encrypt(penc.encode(u)), pe.encrypt(penc.encode(v))
    for j, p in zip(ja.parts + jb.parts, pa.parts + pb.parts):
        np.testing.assert_array_equal(p.numpy(), j)
    jm = jbfv.Evaluator(jctx).mul(ja, jb, jrk)
    pm = bfv.Evaluator(ctx).mul(pa, pb, rk)
    assert len(pm.parts) == 2
    for j, p in zip(jm.parts, pm.parts):
        np.testing.assert_array_equal(p.numpy(), j)
    dec = bfv.Decryptor(ctx, sk)
    np.testing.assert_array_equal(penc.decode(dec.decrypt(pm), 100).numpy(), u * v)
    assert dec.invariant_noise_budget(pm) > 0


def test_bfv_symmetric_encryption_plain_ops_and_integer_encoder(bfv_pair):
    jctx, ctx, (jsk, *_), (sk, *_) = bfv_pair
    ienc, jienc = bfv.IntegerEncoder(ctx), jbfv.IntegerEncoder(jctx)
    ev, dec = bfv.Evaluator(ctx), bfv.Decryptor(ctx, sk)
    ct = bfv.Encryptor(ctx, sk, seed=7).encrypt(ienc.encode(-1234))
    jct = jbfv.Encryptor(jctx, jsk, seed=7).encrypt(jienc.encode(-1234))
    for j, p in zip(jct.parts, ct.parts):
        np.testing.assert_array_equal(p.numpy(), j)
    assert ienc.decode(dec.decrypt(ct)) == -1234
    assert ienc.decode(dec.decrypt(ev.add(ct, ienc.encode(34)))) == -1200
    assert ienc.decode(dec.decrypt(ev.sub(ct, ct))) == 0
    assert ienc.decode(dec.decrypt(ev.mul(ct, ienc.encode(3)))) == -3702
    assert ienc.decode(dec.decrypt(ev.negate(ct))) == 1234
