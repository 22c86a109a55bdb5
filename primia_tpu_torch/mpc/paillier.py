"""Paillier additively homomorphic encryption.

Port of ``primia_tpu/mpc/paillier.py``: textbook Paillier with g = n + 1,
Miller-Rabin key generation, and a tensor of ciphertexts whose values go
through the fixed-point codec of the MPC engine (``mpc/fixed.py``).
Modular exponentiation of 1,024-bit numbers is work for Python's integers
on the host, as in the JAX package (numpy object arrays there too): there
is no tensor work to put on a card, so no function here takes a device.
Values come in as tensors or arrays; :func:`decrypt` returns a float64
CPU tensor. Keys and ciphertexts are plain integers, so either package
decrypts the other's.
"""

from __future__ import annotations

import secrets
from typing import NamedTuple

import numpy as np
import torch

from primia_tpu_torch.mpc import fixed

_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47]


def _is_probable_prime(n: int, rounds: int = 30) -> bool:
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for _ in range(rounds):
        a = secrets.randbelow(n - 3) + 2
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


def _random_prime(bits: int) -> int:
    while True:
        c = secrets.randbits(bits) | (1 << (bits - 1)) | 1
        if _is_probable_prime(c):
            return c


class PublicKey(NamedTuple):
    n: int

    @property
    def n_sq(self) -> int:
        return self.n * self.n

    def raw_encrypt(self, m: int) -> int:
        r = secrets.randbelow(self.n - 1) + 1
        # g = n + 1: g^m = 1 + m n (mod n^2), no exponentiation needed
        return (1 + (m % self.n) * self.n) * pow(r, self.n, self.n_sq) % self.n_sq


class PrivateKey(NamedTuple):
    public: PublicKey
    lam: int  # lcm(p - 1, q - 1)
    mu: int  # L(g^lam mod n^2)^-1 mod n

    def raw_decrypt(self, c: int) -> int:
        n = self.public.n
        m = (pow(c, self.lam, self.public.n_sq) - 1) // n * self.mu % n
        return m - n if m > n // 2 else m  # centred: negatives round-trip


def keygen(bits: int = 1024) -> PrivateKey:
    """Two distinct random primes of ``bits / 2`` bits."""
    while True:
        p = _random_prime(bits // 2)
        q = _random_prime(bits // 2)
        if p != q:
            break
    n = p * q
    lam = (p - 1) * (q - 1)  # gcd(pq, (p - 1)(q - 1)) = 1
    mu = pow(lam, -1, n)  # with g = n + 1, L(g^lam) = lam (mod n)
    return PrivateKey(PublicKey(n), lam, mu)


class PaillierTensor(NamedTuple):
    """Elementwise ciphertexts (a numpy object array of Python ints):
    ciphertext + ciphertext or plaintext, -, and * a plaintext integer."""

    public: PublicKey
    data: np.ndarray
    frac_bits: int

    def __add__(self, other):
        if isinstance(other, PaillierTensor):
            if other.public.n != self.public.n:
                raise ValueError("ciphertexts under different keys")
            nsq = self.public.n_sq
            out = np.frompyfunc(lambda a, b: a * b % nsq, 2, 1)(self.data, other.data)
            return self._replace(data=out)
        return self + encrypt(self.public, other, self.frac_bits)

    def __sub__(self, other):
        if isinstance(other, PaillierTensor):
            return self + other * -1
        return self + -torch.as_tensor(other, dtype=torch.float64)

    def __mul__(self, scalar):
        """Enc(m)^k = Enc(m k) for a plaintext integer k (a float is not
        rescaled: stacked fixed-point scales would need a decryption)."""
        k = int(scalar) % self.public.n
        nsq = self.public.n_sq
        return self._replace(data=np.frompyfunc(lambda c: pow(c, k, nsq), 1, 1)(self.data))

    @property
    def shape(self):
        return self.data.shape


def encrypt(pk: PublicKey, values, frac_bits: int = fixed.DEFAULT_FRAC_BITS) -> PaillierTensor:
    enc = fixed.encode(torch.as_tensor(np.asarray(values, np.float64)), frac_bits).numpy()
    cts = np.frompyfunc(lambda m: pk.raw_encrypt(int(m)), 1, 1)(enc)
    return PaillierTensor(pk, np.asarray(cts, object), frac_bits)


def decrypt(sk: PrivateKey, t: PaillierTensor) -> torch.Tensor:
    ms = np.asarray(np.frompyfunc(lambda c: sk.raw_decrypt(int(c)), 1, 1)(t.data), np.float64)
    return torch.from_numpy(ms) / float(1 << t.frac_bits)
