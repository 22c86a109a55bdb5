"""The port's Threefry PRG, DCF and FSS sign kernel's plain version
against the JAX package, bit for bit.

Inputs are numpy draws handed to both sides: uint32 words (int64 words on
the port's plain side, int32 at the kernel's interface). JAX runs with
x64 on in these processes, so every dtype is pinned. The Pallas kernel
``dcf_sign_fused`` runs in interpret mode, as the JAX package's own tests
run it on the CPU.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from primia_tpu.mpc import dcf as jdcf
from primia_tpu.mpc import prg as jprg
from primia_tpu.ops.pallas_dcf import dcf_sign_fused
from primia_tpu_torch.mpc import dcf, prg
from primia_tpu_torch.ops import cuda_dcf
from primia_tpu_torch.ops._build import read_launches

N_BITS = 31


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """Under the suite's parallel workers, intra-op threads only wait on
    each other (tests/test_torch_mpc.py), so each test runs on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(rng, shape, high=1 << 32):
    return rng.integers(0, high, shape, dtype=np.uint64).astype(np.uint32)


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 -> the port's plain word form (int64 in [0, 2^32))."""
    return torch.from_numpy(a.astype(np.int64))


def _i32(a: np.ndarray) -> torch.Tensor:
    """uint32 -> the kernel interface's int32 words (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_threefry_block_matches_jax():
    rng = np.random.default_rng(0)
    k0, k1, x0, x1 = (_u32(rng, (257,)) for _ in range(4))
    k0[:3] = [0, 0xFFFFFFFF, 0x1BD11BDA]
    want = jprg.threefry2x32(*(jnp.asarray(a, jnp.uint32) for a in (k0, k1, x0, x1)))
    got = prg.threefry2x32(*(_words(a) for a in (k0, k1, x0, x1)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_expand_and_its_child_match_jax():
    rng = np.random.default_rng(1)
    seeds = _u32(rng, (3, 41, 4))
    want = jprg.expand(jnp.asarray(seeds, jnp.uint32))
    got = prg.expand(_words(seeds))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), _np(w))
    sL, tL, vL, sR, tR, vR = (_np(w) for w in want)
    side = rng.integers(0, 2, (3, 41))
    s, t, v = (a.numpy() for a in prg.expand_child(_words(seeds), torch.from_numpy(side)))
    on = side.astype(bool)
    np.testing.assert_array_equal(s, np.where(on[..., None], sR, sL))
    np.testing.assert_array_equal(t, np.where(on, tR, tL))
    np.testing.assert_array_equal(v, np.where(on[..., None], vR, vL))
    v = _u32(rng, (5, 2))
    np.testing.assert_array_equal(prg.words_to_ring(_words(v)).numpy(),
                                  _np(jprg.words_to_ring(jnp.asarray(v, jnp.uint32))))


def _dcf_case(n, seed=3):
    rng = np.random.default_rng(seed)
    seeds = _u32(rng, (2, n, 4))
    alpha = _u32(rng, (n,), 1 << N_BITS)
    x = _u32(rng, (n,), 1 << N_BITS)
    c = _u32(rng, (n,), 2)
    return seeds, alpha, c, x


BOUNDARY = (  # x == alpha (strict <), x = 0, alpha = 0, the domain's ends
    np.array([5, 0, (1 << 31) - 1, 7, 7], np.uint32),
    np.array([5, 0, 0, 6, 8], np.uint32),
)


def test_dcf_keys_and_shares_match_jax():
    seeds, alpha, c, x = _dcf_case(300)
    beta = 1 - 2 * c.astype(np.int64)
    jk = jdcf.dcf_gen_from_seeds(jnp.asarray(seeds, jnp.uint32), jnp.asarray(alpha, jnp.uint32),
                                 jnp.asarray(beta, jnp.int64), n_bits=N_BITS)
    tk = dcf.dcf_gen_from_seeds(_words(seeds), _words(alpha), torch.from_numpy(beta), N_BITS)
    for name, w, g in zip(jk._fields, jk, tk):
        np.testing.assert_array_equal(g.numpy(), _np(w), err_msg=name)
    xj = jnp.asarray(x, jnp.uint32)
    for party in (0, 1):
        np.testing.assert_array_equal(dcf.dcf_eval(party, tk, _words(x), N_BITS).numpy(),
                                      _np(jdcf.dcf_eval(party, jk, xj, n_bits=N_BITS)))
    # a mixed-party batch in one walk, as the JAX party vector
    both = dcf.dcf_eval(torch.tensor([[0], [1]]), tk, _words(x).expand(2, 300), N_BITS)
    np.testing.assert_array_equal(
        both.numpy(), np.stack([_np(jdcf.dcf_eval(p, jk, xj, n_bits=N_BITS)) for p in (0, 1)]))


@pytest.mark.parametrize("case", ["n300", "boundary"])
def test_dcf_sign_plain_matches_the_pallas_kernel(case):
    """The plain version against ``dcf_sign_fused`` (interpret mode) and
    the DCF contract: share sum == (1 - 2c) * 1{x < alpha}."""
    if case == "n300":
        seeds, alpha, c, x = _dcf_case(300)
    else:
        alpha, x = BOUNDARY
        seeds = _u32(np.random.default_rng(1), (2, 5, 4))
        c = np.array([0, 1, 0, 1, 0], np.uint32)
    want = _np(dcf_sign_fused(*(jnp.asarray(a, jnp.uint32) for a in (seeds, alpha, c, x)),
                              interpret=True))
    before = read_launches()
    got = cuda_dcf.dcf_sign(_i32(seeds), _i32(alpha), _i32(c), _i32(x))
    assert got.dtype == torch.int64 and got.shape == (2, len(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cuda_dcf.dcf_sign_plain(_i32(seeds), _i32(alpha), _i32(c), _i32(x)).numpy(), want)
    expect = np.where(x < alpha, 1 - 2 * c.astype(np.int64), 0)
    np.testing.assert_array_equal(got.sum(0).numpy(), expect)
    assert read_launches() == before  # the CPU runs the plain version


def test_dcf_sign_rejects_bad_operands():
    seeds, alpha, c, x = (_i32(a) for a in _dcf_case(8))
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds.long(), alpha, c, x)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds[:, :7], alpha, c, x)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds, alpha, c[:7], x)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds, alpha, c, x, n_bits=33)
    with pytest.raises(ValueError):
        cuda_dcf.dcf_sign(seeds[:, :0], alpha[:0], c[:0], x[:0])


@pytest.mark.parametrize("module", ["ops.cuda_dcf", "mpc.compare", "mpc.inference"])
def test_modules_import_first_in_a_fresh_process(module):
    """No import cycle between the kernel's wrapper and the MPC modules,
    whichever is imported first."""
    root = Path(__file__).resolve().parent.parent
    r = subprocess.run([sys.executable, "-c", f"import primia_tpu_torch.{module}"], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
