"""BFV (Brakerski/Fan-Vercauteren) somewhat homomorphic encryption.

Port of ``primia_tpu/mpc/bfv.py`` over R_q = Z_q[x]/(x^n + 1), q a
product of NTT-friendly 30-bit primes (p = 1 mod 2n). The split between
host and card is the JAX package's:

- the residue arithmetic and the negacyclic NTT (:class:`_NttPlan`, every
  butterfly stage a batched modular product) are int64 torch ops on the
  context's device, which defaults to ``cuda``. Operands stay under 2^30,
  so products stay under 2^60;
- the CRT compose and decompose (the rescale by t/q after a ciphertext
  product, and decryption) stay exact Python integers on the host, as in
  the JAX package: numpy object arrays;
- sampling keeps ``np.random.default_rng(seed)`` in the JAX package's
  order, so keys and ciphertexts equal its own bit for bit from the same
  seeds.

A ciphertext product lifts to an extended prime basis large enough for
the exact tensor product, multiplies there, and rescales; relinearisation
is an RNS gadget key switch (digit i of c2 is its residue mod q_i); the
plain modulus t = 65537 = 1 mod 2n lets :class:`BatchEncoder` pack n
slots. These are demonstration parameters, as in the JAX package, chosen
for correctness and not for a security review.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from primia_tpu_torch import resolve_device

# --------------------------------------------------------------- modular


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = pow(x, 2, n)
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, bits: int, count: int, skip: Sequence[int] = ()) -> List[int]:
    """``count`` primes p = 1 (mod 2n) of about ``bits`` bits, ascending
    from 2^bits."""
    out, step = [], 2 * n
    c = ((1 << bits) // step) * step + 1
    while len(out) < count:
        if c.bit_length() > bits + 1:
            raise RuntimeError("prime search overran")
        if _is_prime(c) and c not in skip:
            out.append(c)
        c += step
    return out


def _primitive_2n_root(n: int, p: int) -> int:
    """psi with psi^n = -1 mod p (a primitive 2n-th root of unity)."""
    for g in range(2, 10000):
        psi = pow(g, (p - 1) // (2 * n), p)
        if pow(psi, n, p) == p - 1:
            return psi
    raise RuntimeError("no primitive root found")


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class _NttPlan:
    """One prime's negacyclic NTT tables on ``device``; the transforms run
    over any leading batch axes."""

    def __init__(self, n: int, p: int, device):
        self.n, self.p = n, p
        psi = _primitive_2n_root(n, p)
        omega = psi * psi % p
        ipsi, iomega = pow(psi, p - 2, p), pow(omega, p - 2, p)

        def powers(b):
            return torch.tensor([pow(b, i, p) for i in range(n)], dtype=torch.int64,
                                device=device)

        self.psi_pows, self.ipsi_pows = powers(psi), powers(ipsi)
        omega_pows, iomega_pows = powers(omega), powers(iomega)
        self.n_inv = pow(n, p - 2, p)
        self.brev = torch.from_numpy(_bit_reverse_perm(n)).to(device)
        # each butterfly stage's twiddles: length 2, 4, ..., n
        lengths = [1 << k for k in range(1, n.bit_length())]
        self.tw = [omega_pows[::n // m][:m // 2] for m in lengths]
        self.itw = [iomega_pows[::n // m][:m // 2] for m in lengths]

    def _core(self, a: torch.Tensor, stages) -> torch.Tensor:
        p, n = self.p, self.n
        a = a[..., self.brev]
        for w in stages:
            half = w.shape[0]
            a = a.reshape(*a.shape[:-1], n // (2 * half), 2 * half)
            lo, hi = a[..., :half], a[..., half:] * w % p
            a = torch.cat([(lo + hi) % p, (lo - hi) % p], dim=-1).reshape(*a.shape[:-2], n)
        return a

    def fwd(self, a: torch.Tensor) -> torch.Tensor:
        return self._core(a * self.psi_pows % self.p, self.tw)

    def inv(self, a: torch.Tensor) -> torch.Tensor:
        b = self._core(a, self.itw) * self.n_inv % self.p
        return b * self.ipsi_pows % self.p


# --------------------------------------------------------------- context

class EncryptionParams(NamedTuple):
    """(poly degree, coefficient prime bits and count, plain modulus)."""

    poly_modulus_degree: int = 2048
    coeff_bits: int = 30
    coeff_count: int = 3
    plain_modulus: int = 65537


class Context:
    """The NTT plans of every prime (base and extended) and the CRT
    constants, on ``device`` (``"cuda"`` by default, or ``"cpu"``)."""

    def __init__(self, params: EncryptionParams = EncryptionParams(), device: str = "cuda"):
        n, t = params.poly_modulus_degree, params.plain_modulus
        if n & (n - 1):
            raise ValueError("poly_modulus_degree must be a power of 2")
        if (t - 1) % (2 * n):
            raise ValueError("plain_modulus must be 1 mod 2n for batching")
        self.device = resolve_device(device)
        self.params = params
        self.n, self.t = n, t
        self.q_primes = ntt_primes(n, params.coeff_bits, params.coeff_count)
        self.q = 1
        for p in self.q_primes:
            self.q *= p
        # the extended basis holds the exact tensor product: |c| <= n (q/2)^2
        need = (self.q ** 2 * n).bit_length() + 2
        extra = max(1, -(-(need - self.q.bit_length()) // (params.coeff_bits - 1)))
        self.ext_primes = self.q_primes + ntt_primes(n, params.coeff_bits, extra,
                                                     skip=self.q_primes)
        self.plans: Dict[int, _NttPlan] = {p: _NttPlan(n, p, self.device)
                                           for p in self.ext_primes}
        self.delta = self.q // t
        self._mods = {}
        self.delta_mod = self.tensor([self.delta % p for p in self.q_primes])
        self._compose_cache = {}

    def tensor(self, values) -> torch.Tensor:
        """Host integers or an int64 array -> an int64 tensor on the device."""
        return torch.as_tensor(np.asarray(values, np.int64)).to(self.device)

    def mods(self, primes: Sequence[int]) -> torch.Tensor:
        """(k, 1) moduli on the device, made once a basis."""
        key = tuple(primes)
        if key not in self._mods:
            self._mods[key] = self.tensor(list(primes)).reshape(-1, 1)
        return self._mods[key]

    def _compose_consts(self, primes: Sequence[int]):
        key = tuple(primes)
        if key not in self._compose_cache:
            M = 1
            for p in primes:
                M *= p
            self._compose_cache[key] = (M, [((M // p) * pow((M // p) % p, p - 2, p)) % M
                                            for p in primes])
        return self._compose_cache[key]

    def compose(self, limbs: torch.Tensor, primes: Sequence[int]) -> np.ndarray:
        """(k, ..., n) residues -> centred integer coefficients in (-M/2,
        M/2], an object array on the host: one of the two steps (with the
        t/q rescale) that BFV cannot keep in residues."""
        M, consts = self._compose_consts(primes)
        res = limbs.cpu().numpy()
        acc = np.zeros(res.shape[1:], object)
        for r, c in zip(res, consts):
            acc = acc + r.astype(object) * c
        acc = acc % M
        return np.where(acc > M // 2, acc - M, acc)

    def decompose(self, coeffs: np.ndarray, primes: Sequence[int]) -> torch.Tensor:
        """Integer (object) coefficients -> (k, ...) int64 residues on the
        device."""
        return self.tensor(np.stack([
            np.frompyfunc(lambda c, pp=p: int(c) % pp, 1, 1)(coeffs).astype(np.int64)
            for p in primes]))


# ------------------------------------------------------------------ keys

class SecretKey(NamedTuple):
    data: torch.Tensor  # (k, n) residues of a ternary polynomial


class PublicKey(NamedTuple):
    p0: torch.Tensor  # (k, n)
    p1: torch.Tensor


class RelinKeys(NamedTuple):
    r0: torch.Tensor  # (k digits, k, n)
    r1: torch.Tensor


def _sample_ternary(rng, n) -> np.ndarray:
    return rng.integers(-1, 2, n).astype(np.int64)


def _sample_error(rng, n) -> np.ndarray:
    """A centred binomial of 21 + 21 coins (variance 10.5, about sigma
    3.2 squared)."""
    k = 21
    return (rng.integers(0, 2, (k, n)).sum(0) - rng.integers(0, 2, (k, n)).sum(0)
            ).astype(np.int64)


def _sample_uniform(ctx: Context, rng) -> torch.Tensor:
    """(k, n) uniform residues, one prime after another."""
    return ctx.tensor(np.stack([rng.integers(0, p, ctx.n) for p in ctx.q_primes]))


def _to_rns(ctx: Context, poly, primes=None) -> torch.Tensor:
    primes = primes or ctx.q_primes
    poly = ctx.tensor(poly) if isinstance(poly, np.ndarray) else poly
    return poly.unsqueeze(0) % ctx.mods(primes)


def _poly_mul_rns(ctx: Context, a: torch.Tensor, b: torch.Tensor, primes=None) -> torch.Tensor:
    """The negacyclic product, limb by limb, through the NTT."""
    primes = primes or ctx.q_primes
    out = []
    for i, p in enumerate(primes):
        plan = ctx.plans[p]
        out.append(plan.inv(plan.fwd(a[i]) * plan.fwd(b[i]) % p))
    return torch.stack(out)


def _add(ctx: Context, a, b, primes) -> torch.Tensor:
    return (a + b) % ctx.mods(primes).reshape(-1, *([1] * (a.dim() - 1)))


def _sub(ctx: Context, a, b, primes) -> torch.Tensor:
    return (a - b) % ctx.mods(primes).reshape(-1, *([1] * (a.dim() - 1)))


class KeyGenerator:
    """The secret, public and relinearisation keys, sampled from
    ``seed``."""

    def __init__(self, context: Context, seed: int = 0):
        self.ctx = context
        self.rng = np.random.default_rng(seed)

    def keygen(self):
        ctx, rng, qp = self.ctx, self.rng, self.ctx.q_primes
        s = _to_rns(ctx, _sample_ternary(rng, ctx.n))
        a = _sample_uniform(ctx, rng)
        e = _to_rns(ctx, _sample_error(rng, ctx.n))
        p0 = _sub(ctx, torch.zeros_like(a), _add(ctx, _poly_mul_rns(ctx, a, s), e, qp), qp)
        self.secret_key = SecretKey(s)
        self.public_key = PublicKey(p0, a)
        self.relin_keys = self._make_relin(s)
        return self.secret_key, self.public_key, self.relin_keys

    def _make_relin(self, s: torch.Tensor) -> RelinKeys:
        """RNS gadget keys: rk_i encrypts qhat_i s^2, qhat_i = (q / q_i)
        [(q / q_i)^-1 mod q_i]."""
        ctx, rng, qp = self.ctx, self.rng, self.ctx.q_primes
        s2 = _poly_mul_rns(ctx, s, s)
        r0s, r1s = [], []
        for qi in qp:
            Mi = ctx.q // qi
            qhat = Mi * pow(Mi % qi, qi - 2, qi)
            qhat_mod = ctx.tensor([qhat % p for p in qp]).reshape(-1, 1)
            a = _sample_uniform(ctx, rng)
            e = _to_rns(ctx, _sample_error(rng, ctx.n))
            body = _add(ctx, _poly_mul_rns(ctx, a, s), e, qp)
            target = s2 * qhat_mod % ctx.mods(qp)
            r0s.append(_sub(ctx, target, body, qp))
            r1s.append(a)
        return RelinKeys(torch.stack(r0s), torch.stack(r1s))


# ------------------------------------------------------------ ct / plain

class Plaintext(NamedTuple):
    data: torch.Tensor  # (n,) int64 coefficients mod t


class Ciphertext(NamedTuple):
    parts: tuple  # (k, n) residue polynomials; 2 of them, 3 before relin


def _delta_m(ctx: Context, m: torch.Tensor) -> torch.Tensor:
    """delta * (m mod t) as (k, n) residues."""
    return ctx.delta_mod[:, None] * (m % ctx.t)[None, :] % ctx.mods(ctx.q_primes)


class Encryptor:
    """Public-key or secret-key encryption, by the key it is given;
    randomness from ``seed``."""

    def __init__(self, context: Context, key, seed: int = 1):
        self.ctx = context
        self.key = key
        self.rng = np.random.default_rng(seed)

    def encrypt(self, plain: Plaintext) -> Ciphertext:
        ctx, rng, qp = self.ctx, self.rng, self.ctx.q_primes
        delta_m = _delta_m(ctx, plain.data)
        if isinstance(self.key, PublicKey):
            u = _to_rns(ctx, _sample_ternary(rng, ctx.n))
            e1 = _to_rns(ctx, _sample_error(rng, ctx.n))
            e2 = _to_rns(ctx, _sample_error(rng, ctx.n))
            c0 = _add(ctx, _add(ctx, _poly_mul_rns(ctx, self.key.p0, u), e1, qp), delta_m, qp)
            c1 = _add(ctx, _poly_mul_rns(ctx, self.key.p1, u), e2, qp)
            return Ciphertext((c0, c1))
        a = _sample_uniform(ctx, rng)  # symmetric: a fresh a a ciphertext
        e = _to_rns(ctx, _sample_error(rng, ctx.n))
        body = _add(ctx, _poly_mul_rns(ctx, a, self.key.data), e, qp)
        c0 = _add(ctx, _sub(ctx, torch.zeros_like(body), body, qp), delta_m, qp)
        return Ciphertext((c0, a))


class Decryptor:
    """Evaluates the ciphertext polynomial at the secret key (any size)
    and rounds t/q times it."""

    def __init__(self, context: Context, secret_key: SecretKey):
        self.ctx = context
        self.sk = secret_key

    def _phase(self, ct: Ciphertext) -> np.ndarray:
        """c0 + c1 s + c2 s^2 + ..., composed to centred integers."""
        ctx = self.ctx
        acc = ct.parts[0]
        s_pow = self.sk.data
        for part in ct.parts[1:]:
            acc = _add(ctx, acc, _poly_mul_rns(ctx, part, s_pow), ctx.q_primes)
            s_pow = _poly_mul_rns(ctx, s_pow, self.sk.data)
        return ctx.compose(acc, ctx.q_primes)

    def decrypt(self, ct: Ciphertext) -> Plaintext:
        t, q = self.ctx.t, self.ctx.q
        vec = np.frompyfunc(lambda c: ((2 * t * int(c) + q) // (2 * q)) % t, 1, 1)(
            self._phase(ct))
        return Plaintext(self.ctx.tensor(vec.astype(np.int64)))

    def invariant_noise_budget(self, ct: Ciphertext) -> float:
        """Bits of noise budget left (a SEAL-style diagnostic)."""
        t, q = self.ctx.t, self.ctx.q
        noise = max(abs(int(t * int(c) - q * ((2 * t * int(c) + q) // (2 * q))))
                    for c in self._phase(ct).ravel())
        return max(0.0, (q // 2).bit_length() - max(noise, 1).bit_length() - 1)


class Evaluator:
    """add, sub, negate and mul on ciphertexts and plaintexts, and
    relinearisation."""

    def __init__(self, context: Context):
        self.ctx = context

    def add(self, a, b):
        if isinstance(a, Plaintext) and isinstance(b, Plaintext):
            return Plaintext((a.data + b.data) % self.ctx.t)
        if isinstance(a, Plaintext):
            a, b = b, a
        if isinstance(b, Plaintext):
            c0 = _add(self.ctx, a.parts[0], _delta_m(self.ctx, b.data), self.ctx.q_primes)
            return Ciphertext((c0,) + a.parts[1:])
        parts = []
        for i in range(max(len(a.parts), len(b.parts))):
            x = a.parts[i] if i < len(a.parts) else None
            y = b.parts[i] if i < len(b.parts) else None
            parts.append(y if x is None else x if y is None
                         else _add(self.ctx, x, y, self.ctx.q_primes))
        return Ciphertext(tuple(parts))

    def negate(self, ct: Ciphertext) -> Ciphertext:
        return Ciphertext(tuple(_sub(self.ctx, torch.zeros_like(p), p, self.ctx.q_primes)
                                for p in ct.parts))

    def sub(self, a, b):
        if isinstance(a, Plaintext) and isinstance(b, Plaintext):
            return Plaintext((a.data - b.data) % self.ctx.t)
        if isinstance(b, Plaintext):
            return self.add(a, Plaintext((-b.data) % self.ctx.t))
        return self.add(a, self.negate(b))

    def mul(self, a, b, relin_keys: Optional[RelinKeys] = None):
        if isinstance(a, Plaintext) and isinstance(b, Plaintext):
            t = self.ctx.t
            plan = self._plain_plan()
            return Plaintext(plan.inv(plan.fwd(a.data % t) * plan.fwd(b.data % t) % t))
        if isinstance(a, Plaintext):
            a, b = b, a
        if isinstance(b, Plaintext):
            m = _to_rns(self.ctx, b.data % self.ctx.t)
            return Ciphertext(tuple(_poly_mul_rns(self.ctx, p, m) for p in a.parts))
        out = self._mul_cipher_cipher(a, b)
        return out if relin_keys is None else self.relin(out, relin_keys)

    def _plain_plan(self) -> _NttPlan:
        t = self.ctx.t
        if t not in self.ctx.plans:
            self.ctx.plans[t] = _NttPlan(self.ctx.n, t, self.ctx.device)
        return self.ctx.plans[t]

    def _mul_cipher_cipher(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """The exact tensor product in the extended basis, then the rounded
        t/q rescale on the host."""
        ctx = self.ctx
        if len(a.parts) != 2 or len(b.parts) != 2:
            raise ValueError("mul expects size-2 ciphertexts (relin first)")

        def lift(part):
            return ctx.decompose(ctx.compose(part, ctx.q_primes), ctx.ext_primes)

        a0, a1, b0, b1 = (lift(p) for p in (*a.parts, *b.parts))
        ext = ctx.ext_primes
        e0 = _poly_mul_rns(ctx, a0, b0, ext)
        e1 = _add(ctx, _poly_mul_rns(ctx, a0, b1, ext), _poly_mul_rns(ctx, a1, b0, ext), ext)
        e2 = _poly_mul_rns(ctx, a1, b1, ext)
        t, q = ctx.t, ctx.q

        def scale_down(e):
            scaled = np.frompyfunc(lambda c: (2 * t * int(c) + q) // (2 * q), 1, 1)(
                ctx.compose(e, ext))
            return ctx.decompose(scaled, ctx.q_primes)

        return Ciphertext((scale_down(e0), scale_down(e1), scale_down(e2)))

    def relin(self, ct: Ciphertext, keys: RelinKeys) -> Ciphertext:
        """Size 3 -> 2 by the RNS gadget key switch."""
        if len(ct.parts) == 2:
            return ct
        if len(ct.parts) != 3:
            raise ValueError("relin supports size-3 ciphertexts")
        ctx, qp = self.ctx, self.ctx.q_primes
        c0, c1, c2 = ct.parts
        for i in range(len(qp)):
            # digit i: c2's residue mod q_i (below q_i, so reduced mod every
            # limb's prime), spread across the limbs
            d = c2[i].expand_as(c2)
            c0 = _add(ctx, c0, _poly_mul_rns(ctx, d, keys.r0[i]), qp)
            c1 = _add(ctx, c1, _poly_mul_rns(ctx, d, keys.r1[i]), qp)
        return Ciphertext((c0, c1))


# -------------------------------------------------------------- encoders

class IntegerEncoder:
    """Binary expansion: an integer's bits become coefficients; decoding
    evaluates at x = 2."""

    def __init__(self, context: Context):
        self.ctx = context

    def encode(self, value: int) -> Plaintext:
        n, t = self.ctx.n, self.ctx.t
        coeffs = np.zeros(n, np.int64)
        v, sign = abs(int(value)), 1 if value >= 0 else -1
        if v.bit_length() > n:
            raise ValueError("integer too large for the polynomial degree")
        for i in range(v.bit_length()):
            if (v >> i) & 1:
                coeffs[i] = sign % t
        return Plaintext(self.ctx.tensor(coeffs))

    def decode(self, plain: Plaintext) -> int:
        t = self.ctx.t
        d = plain.data.cpu().numpy()
        centred = np.where(d > t // 2, d - t, d)
        return int(sum(int(c) << i for i, c in enumerate(centred)))


class BatchEncoder:
    """SIMD slots through the mod-t negacyclic NTT (t = 1 mod 2n): n
    integer slots a plaintext, slot-wise under the evaluator's ring ops."""

    def __init__(self, context: Context):
        self.ctx = context
        if (context.t - 1) % (2 * context.n):
            raise ValueError("plain modulus not NTT-friendly")
        self.plan = _NttPlan(context.n, context.t, context.device)

    def encode(self, values) -> Plaintext:
        v = np.zeros(self.ctx.n, np.int64)
        arr = np.asarray(values, np.int64).ravel() % self.ctx.t
        v[:arr.size] = arr
        return Plaintext(self.plan.inv(self.ctx.tensor(v)))

    def decode(self, plain: Plaintext, count: Optional[int] = None) -> torch.Tensor:
        t = self.ctx.t
        slots = self.plan.fwd(plain.data % t)
        slots = torch.where(slots > t // 2, slots - t, slots)
        return slots[:count] if count else slots
