"""The port's SecureNN (``mpc/securenn.py``) against the JAX package's.

Integer code is held bit for bit: the bit decomposition and the borrow
circuit from the same public c and the same explicit dealer material; the
sign's reveal from the same ``SnnKeys`` at 32 and 64 bits, ring edges
included; Z_{2^64 - 1} addition, negation and opening on edge values.
Unsigned values cross between the packages as numpy bit patterns (uint32,
or uint64 viewed as int64). The protocols with their own draws are held
to the value they compute: sign, select, share conversion, division.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.mpc import securenn as jsn
from primia_tpu.mpc import shares as JS
from primia_tpu.mpc.shares import AShare as JAShare
from primia_tpu_torch.mpc import securenn as sn
from primia_tpu_torch.mpc import shares as S
from primia_tpu_torch.mpc.shares import AShare

M = (1 << 64) - 1
EDGES_U64 = [0, 1, 2, M - 1, M - 2, 1 << 63, (1 << 63) - 1, (1 << 63) + 1, 123456789,
             0xDEADBEEFCAFEBABE]


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u64(vals):
    return np.array(vals, dtype=np.uint64)


def _i64(u):
    """uint64 bit patterns as the port's int64."""
    return torch.from_numpy(np.ascontiguousarray(u).view(np.int64))


def _share_np(rng, v):
    """Two int64 shares of v (wrapping)."""
    r = rng.integers(-(1 << 63), (1 << 63) - 1, v.shape, dtype=np.int64, endpoint=True)
    with np.errstate(over="ignore"):
        return np.stack([v - r, r])


def _bits(rng, n, n_bits):
    return rng.integers(0, 1 << n_bits, n, dtype=np.uint64, endpoint=False) if n_bits < 64 \
        else rng.integers(0, M, n, dtype=np.uint64, endpoint=True)


def _keys_np(rng, n, n_bits):
    """Explicit dealer material for n signs over Z_2^n_bits, as numpy."""
    udt = np.uint32 if n_bits == 32 else np.uint64
    nb = n_bits - 1
    r = _bits(rng, n, n_bits).astype(udt)
    r0 = _bits(rng, n, n_bits).astype(udt)
    with np.errstate(over="ignore"):
        r_sh = np.stack([r0, r - r0])
    rbits = ((r[:, None].astype(np.uint64) >> np.arange(nb - 1, -1, -1, dtype=np.uint64))
             & np.uint64(1)).astype(np.int32)
    rb0 = rng.integers(0, 67, (n, nb), dtype=np.int32)
    rbits_sh = np.stack([rb0, (rbits - rb0) % 67]).astype(np.int32)
    b_r = _share_np(rng, (r.astype(np.uint64) >> np.uint64(nb)).astype(np.int64))
    s = rng.integers(1, 67, (n, nb), dtype=np.int32)
    u = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64, endpoint=True)
    return r_sh, rbits_sh, b_r, s, u


def _jax_keys(k):
    r_sh, rbits_sh, b_r, s, u = k
    return jsn.SnnKeys(jnp.asarray(r_sh), jnp.asarray(rbits_sh), JAShare(jnp.asarray(b_r)),
                       jnp.asarray(s), jnp.asarray(u))


def _port_keys(k):
    r_sh, rbits_sh, b_r, s, u = k
    r = torch.from_numpy(r_sh.astype(np.int64)) if r_sh.dtype == np.uint32 else _i64(r_sh)
    return sn.SnnKeys(r, torch.from_numpy(rbits_sh), AShare(torch.from_numpy(b_r)),
                      torch.from_numpy(s), torch.from_numpy(u))


# ------------------------------------------------------ bit for bit

@pytest.mark.parametrize("n_bits", [32, 64])
def test_decompose_and_borrow_match_jax(n_bits):
    """The same public c and explicit r-bit shares and masks: the bits and
    the dealer's borrow 1{c' < r'} equal JAX's, and the borrow is the
    comparison of the low n-1 bits."""
    rng = np.random.default_rng(n_bits)
    n, nb = 500, n_bits - 1
    udt = np.uint32 if n_bits == 32 else np.uint64
    c = _bits(rng, n, n_bits).astype(udt)
    k = _keys_np(rng, n, n_bits)
    # ring edges for c, and r's low bits equal to c's on a few (no borrow)
    c[:6] = np.array([0, 1, (1 << (n_bits - 1)) - 1, 1 << (n_bits - 1), (1 << n_bits) - 1, 2],
                     dtype=np.uint64).astype(udt)
    port_c = torch.from_numpy(c.astype(np.int64)) if n_bits == 32 else _i64(c)
    jbits = np.asarray(jsn._decompose(jnp.asarray(c), nb))
    pbits = sn._decompose(port_c, nb)
    np.testing.assert_array_equal(pbits.numpy().astype(np.int32), jbits)
    jb = np.asarray(jsn._borrow(jnp.asarray(jbits), jnp.asarray(k[1]), jnp.asarray(k[3])))
    pb = sn._borrow(pbits, torch.from_numpy(k[1]), torch.from_numpy(k[3]))
    assert pb.dtype == torch.int64
    np.testing.assert_array_equal(pb.numpy(), jb)
    low = np.uint64((1 << nb) - 1)
    with np.errstate(over="ignore"):
        r = (k[0][0] + k[0][1]).astype(np.uint64)
    np.testing.assert_array_equal(pb.numpy(), ((c.astype(np.uint64) & low) < (r & low)))


@pytest.mark.parametrize("n_bits", [32, 64])
def test_msb_reveals_what_jax_reveals_from_the_same_keys(n_bits):
    """Both packages' ``msb`` from one numpy ``SnnKeys`` and one sharing:
    equal reveals, which are 1{x < 0}, at the ring edges of the domain."""
    rng = np.random.default_rng(10 + n_bits)
    half = 1 << (n_bits - 1)
    v = rng.integers(-(half // 2), half // 2, 300, dtype=np.int64)
    edges = [0, 1, -1, 2, -2, half // 2, -(half // 2), half - 1 - 65536, -(half - 65536),
             half - 1, -half + 1]
    v[:len(edges)] = edges
    sh = _share_np(rng, v)
    k = _keys_np(rng, v.size, n_bits)
    j = JS.reconstruct(jsn.msb(jax.random.PRNGKey(1), JAShare(jnp.asarray(sh)), _jax_keys(k)))
    p = S.reconstruct(sn.msb(torch.Generator().manual_seed(1), AShare(torch.from_numpy(sh)),
                             _port_keys(k)))
    np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    np.testing.assert_array_equal(p.numpy(), (v < 0).astype(np.int64))


def test_mod_m_arithmetic_matches_jax():
    """add_mod_m, neg_mod_m and reconstruct_mod_m on every pair of edge
    values below M, bit for bit against JAX and against Python integers."""
    vals = [x for x in EDGES_U64 if x < M]
    a = _u64([x for x in vals for _ in vals])
    b = _u64([y for _ in vals for y in vals])
    got = sn.add_mod_m(_i64(a), _i64(b)).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, np.asarray(jsn.add_mod_m(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(got, _u64([(int(x) + int(y)) % M for x, y in zip(a, b)]))
    neg = sn.neg_mod_m(_i64(a)).numpy().view(np.uint64)
    np.testing.assert_array_equal(neg, np.asarray(jsn.neg_mod_m(jnp.asarray(a))))
    np.testing.assert_array_equal(neg, _u64([(M - int(x)) % M for x in a]))
    opened = sn.reconstruct_mod_m(torch.stack([_i64(a), _i64(b)])).numpy().view(np.uint64)
    np.testing.assert_array_equal(opened, np.asarray(jsn.reconstruct_mod_m(
        jnp.stack([jnp.asarray(a), jnp.asarray(b)]))))
    # unsigned order of int64 bit patterns
    assert sn._ult(_i64(_u64([1])), _i64(_u64([1 << 63]))).item()
    assert not sn._ult(_i64(_u64([M])), _i64(_u64([0]))).item()


# ------------------------------------------- the dealer and the protocols

@pytest.mark.parametrize("n_bits", [32, 64])
def test_gen_sign_keys_are_consistent(n_bits):
    """r's shares, r's bit shares (mod 67) and its top bit reconstruct to one
    r; the masks lie in [1, 66]."""
    n, nb = 2000, n_bits - 1
    k = sn.gen_sign(torch.Generator().manual_seed(3), n, n_bits)
    r = k.r_sh[0] + k.r_sh[1]
    if n_bits == 32:
        assert bool(((k.r_sh >= 0) & (k.r_sh < 1 << 32)).all())
        r = r & sn.MASK32
    bits = (k.rbits_sh[0].long() + k.rbits_sh[1].long()) % 67
    assert torch.equal(bits, sn._decompose(r, nb).long())
    assert torch.equal(S.reconstruct(k.b_r), (r >> nb) & 1)
    assert int(k.s.min()) == 1 and int(k.s.max()) == 66
    assert k.rbits_sh.dtype == k.s.dtype == torch.int16
    assert 800 < int(((r >> nb) & 1).sum()) < 1200  # the top bit varies


@pytest.mark.parametrize("n_bits", [32, 64])
def test_sign_shares_reconstruct_to_the_sign(n_bits):
    rng = np.random.default_rng(20 + n_bits)
    lim = 1 << (30 if n_bits == 32 else 61)
    v = rng.integers(-lim, lim, (4, 5, 7), dtype=np.int64)
    v.reshape(-1)[:7] = [0, 1, -1, lim, -lim, lim - 1, -lim + 1]
    gen = torch.Generator().manual_seed(4)
    sign = sn.sign_shares(gen, S.share(gen, torch.from_numpy(v)), n_bits=n_bits)
    assert sign.shape == v.shape
    np.testing.assert_array_equal(S.reconstruct(sign).numpy(), (v < 0).astype(np.int64))


def test_select_share():
    gen = torch.Generator().manual_seed(5)
    x = torch.tensor([10, -5, 7, 0, 1 << 40])
    y = torch.tensor([-1, 99, 7, 3, -(1 << 40)])
    alpha = torch.tensor([0, 1, 1, 0, 1])
    sx = S.share(gen, x)
    out = sn.select_share(gen, S.share(gen, alpha), sx, S.share(gen, y))
    assert torch.equal(S.reconstruct(out), torch.where(alpha == 1, y, x))
    assert not torch.equal(out.data[0], sx.data[0])  # re-randomised


def test_share_convert_opens_mod_m_to_the_value():
    """Z_2^64 -> Z_{2^64 - 1}: the value kept, each party's share masked
    (identical values give distinct shares)."""
    rng = np.random.default_rng(6)
    v = rng.integers(0, 1 << 62, 64, dtype=np.int64)
    v[:4] = [0, 1, (1 << 62) - 1, 5]
    v[-3:] = [-1 - 1, -(1 << 62), -12345]  # negatives: 2^64 - |v| below M
    gen = torch.Generator().manual_seed(7)
    conv = sn.share_convert(gen, S.share(gen, torch.from_numpy(v)))
    assert conv.shape == (2, 64)
    np.testing.assert_array_equal(sn.reconstruct_mod_m(conv).numpy(), v)
    same = sn.share_convert(gen, S.share(gen, torch.full((256,), 5, dtype=torch.int64)))
    for p in range(2):
        assert same[p].unique().numel() == 256


def test_division_integer_and_scalar_divisor():
    """Exact floor quotients (tests/test_securenn_extra.py's cases)."""
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1 << 20, 16, dtype=np.int64)
    y = rng.integers(1, 1 << 10, 16, dtype=np.int64)
    x[:2], y[:2] = [0, 7], [3, 7]
    gen = torch.Generator().manual_seed(8)
    sx, sy = S.share(gen, torch.from_numpy(x)), S.share(gen, torch.from_numpy(y))
    q = sn.division(gen, sx, sy, bit_len_max=24)
    np.testing.assert_array_equal(S.reconstruct(q).numpy(), x // y)
    x3 = torch.tensor([100, 20, 3])
    q = sn.division(gen, S.share(gen, x3), S.share(gen, torch.tensor([7])), bit_len_max=8)
    np.testing.assert_array_equal(S.reconstruct(q).numpy(), [14, 2, 0])
    with pytest.raises(ValueError, match="divisor shape"):
        sn.division(gen, sx, S.share(gen, torch.tensor([1, 2])))
