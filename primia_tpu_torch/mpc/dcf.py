"""Distributed comparison function (DCF): key generation and evaluation.

Port of ``primia_tpu/mpc/dcf.py`` (Boyle-Gilboa-Ishai's DCF and DPF
with the Threefry PRG of ``mpc/prg.py``), bit for bit given the same root
seeds. ``dcf_gen_from_seeds`` and ``dcf_eval`` together are the plain
version of the FSS sign kernel K4 (``ops/cuda_dcf.py:dcf_sign_plain``)
and the comparison's online walk (``compare.msb``); the DPF
(``dpf_gen``, ``dpf_eval``) is plain torch on any device, as the JAX
package runs it in XLA.

Domain: n-bit unsigned points (words in int64 tensors, as in
``mpc/prg.py``); payload group Z_{2^64} (int64, wrapping). Each level
runs every walk of the batch through one PRG call: the two parties' key
walks through ``expand`` together, and any number of evaluations through
``expand_child``, which computes only the child on the path.

Key layout (batch N, domain n):
    seeds:    (2, N, 4)  per-party root seeds
    s_cw:     (n, N, 4)  seed correction words
    t_cw:     (n, N, 2)  control-bit corrections (L, R)
    v_cw:     (n, N)     value corrections
    last_cw:  (N,)       final output correction
A DPF key has no v_cw.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from primia_tpu_torch.mpc.prg import expand, expand_child, words_to_ring

N_BITS_DEFAULT = 32


class DpfKeys(NamedTuple):
    seeds: torch.Tensor
    s_cw: torch.Tensor
    t_cw: torch.Tensor
    last_cw: torch.Tensor


class DcfKeys(NamedTuple):
    seeds: torch.Tensor
    s_cw: torch.Tensor
    t_cw: torch.Tensor
    v_cw: torch.Tensor
    last_cw: torch.Tensor


def _bit(v: torch.Tensor, i: int, n_bits: int) -> torch.Tensor:
    """The i-th bit of v, most significant first, as int64 0/1."""
    return (v >> (n_bits - 1 - i)) & 1


def _sel(bit: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bit == 0 -> a, bit == 1 -> b, for (..., k) words and a (...) bit."""
    return torch.where(bit.unsqueeze(-1) == 1, b, a)


def dcf_gen_from_seeds(seeds: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                       n_bits: int = N_BITS_DEFAULT) -> DcfKeys:
    """Keys for f(x) = beta * 1{x < alpha} (unsigned n-bit) from explicit
    (2, N, 4) root seeds; alpha (N,) words, beta (N,) int64."""
    N = alpha.shape[0]
    dev = alpha.device
    s = seeds  # (2, N, 4): both parties' walks
    t = torch.stack([torch.zeros(N, dtype=torch.int64, device=dev),
                     torch.ones(N, dtype=torch.int64, device=dev)])
    v_alpha = torch.zeros(N, dtype=torch.int64, device=dev)
    s_cws, t_cws, v_cws = [], [], []
    for i in range(n_bits):
        a = _bit(alpha, i, n_bits)
        sL, tL, vL, sR, tR, vR = expand(s)
        # a == 0: keep L, lose R; a == 1: keep R, lose L
        s_lose = _sel(a, sR, sL)
        v_lose = words_to_ring(_sel(a, vR, vL))
        v_keep = words_to_ring(_sel(a, vL, vR))
        sign1 = 1 - 2 * t[1]
        v_cw = sign1 * (v_lose[1] - v_lose[0] - v_alpha)
        v_cw = v_cw + a * sign1 * beta  # when alpha_i == 1, x_i == 0 is below alpha
        v_alpha = v_alpha - v_keep[1] + v_keep[0] + sign1 * v_cw
        s_cw = s_lose[0] ^ s_lose[1]
        t_cw_L = tL[0] ^ tL[1] ^ a ^ 1
        t_cw_R = tR[0] ^ tR[1] ^ a
        t_cw_keep = torch.where(a == 1, t_cw_R, t_cw_L)
        s = _sel(a, sL, sR) ^ (s_cw * t.unsqueeze(-1))
        t = torch.where(a == 1, tR, tL) ^ (t * t_cw_keep)
        s_cws.append(s_cw)
        t_cws.append(torch.stack([t_cw_L, t_cw_R], dim=-1))
        v_cws.append(v_cw)
    sign1 = 1 - 2 * t[1]
    conv = words_to_ring(s[..., :2])
    last_cw = sign1 * (conv[1] - conv[0] - v_alpha)
    return DcfKeys(seeds=seeds, s_cw=torch.stack(s_cws), t_cw=torch.stack(t_cws),
                   v_cw=torch.stack(v_cws), last_cw=last_cw)


def dcf_eval(party: Union[int, torch.Tensor], keys: DcfKeys, x: torch.Tensor,
             n_bits: int = N_BITS_DEFAULT) -> torch.Tensor:
    """Party b's additive share of beta * 1{x < alpha}.

    ``x``: (..., N) words. ``party``: 0, 1, or an int64 tensor of 0/1 that
    broadcasts against ``x`` (a mixed-party batch, as the JAX package's
    party vector: ``party = [[0], [1]]`` with ``x`` expanded to (2, N)
    evaluates both parties in one walk). Keys broadcast along the last
    axis."""
    party = torch.as_tensor(party, dtype=torch.int64, device=x.device)
    party = torch.broadcast_to(party, x.shape)
    sign_b = 1 - 2 * party
    s = _sel(party, keys.seeds[0], keys.seeds[1])
    t = party
    v = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for i in range(n_bits):
        xb = _bit(x, i, n_bits)
        # only the child on x's path: the corrections apply to both alike
        s_x, t_x, v_x = expand_child(s, xb)
        t_cw = torch.where(xb == 1, keys.t_cw[i][..., 1], keys.t_cw[i][..., 0])
        v = v + sign_b * (words_to_ring(v_x) + t * keys.v_cw[i])
        s = s_x ^ (keys.s_cw[i] * t.unsqueeze(-1))
        t = t_x ^ (t * t_cw)
    return v + sign_b * (words_to_ring(s[..., :2]) + t * keys.last_cw)


# ---------------------------------------------------------------- DPF

def dpf_gen_from_seeds(seeds: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                       n_bits: int = N_BITS_DEFAULT) -> DpfKeys:
    """Keys for f(x) = beta * 1{x == alpha} from explicit (2, N, 4) root
    seeds; alpha (N,) words, beta (N,) int64."""
    N = alpha.shape[0]
    dev = alpha.device
    s = seeds
    t = torch.stack([torch.zeros(N, dtype=torch.int64, device=dev),
                     torch.ones(N, dtype=torch.int64, device=dev)])
    s_cws, t_cws = [], []
    for i in range(n_bits):
        a = _bit(alpha, i, n_bits)
        sL, tL, _, sR, tR, _ = expand(s)
        s_lose = _sel(a, sR, sL)
        s_cw = s_lose[0] ^ s_lose[1]
        t_cw_L = tL[0] ^ tL[1] ^ a ^ 1
        t_cw_R = tR[0] ^ tR[1] ^ a
        t_cw_keep = torch.where(a == 1, t_cw_R, t_cw_L)
        s = _sel(a, sL, sR) ^ (s_cw * t.unsqueeze(-1))
        t = torch.where(a == 1, tR, tL) ^ (t * t_cw_keep)
        s_cws.append(s_cw)
        t_cws.append(torch.stack([t_cw_L, t_cw_R], dim=-1))
    conv = words_to_ring(s[..., :2])
    last_cw = (1 - 2 * t[1]) * (beta + conv[1] - conv[0])
    return DpfKeys(seeds=seeds, s_cw=torch.stack(s_cws), t_cw=torch.stack(t_cws),
                   last_cw=last_cw)


def dpf_gen(gen: torch.Generator, alpha: torch.Tensor, beta: torch.Tensor,
            n_bits: int = N_BITS_DEFAULT) -> DpfKeys:
    """DPF keys with root seeds drawn from ``gen``: (2, N, 4) 32-bit words."""
    seeds = torch.randint(0, 1 << 32, (2, alpha.shape[0], 4), dtype=torch.int64,
                          generator=gen, device=gen.device)
    return dpf_gen_from_seeds(seeds, alpha, beta, n_bits)


def dpf_eval(party: int, keys: DpfKeys, x: torch.Tensor,
             n_bits: int = N_BITS_DEFAULT) -> torch.Tensor:
    """Party b's additive share of beta * 1{x == alpha}; x (N,) words.
    Each level expands only the child on x's path (``expand_child``), the
    same words as the JAX package's full expansion and select."""
    s = keys.seeds[party]
    t = torch.full(x.shape, party, dtype=torch.int64, device=x.device)
    for i in range(n_bits):
        xb = _bit(x, i, n_bits)
        s_x, t_x, _ = expand_child(s, xb)
        t_cw = torch.where(xb == 1, keys.t_cw[i][..., 1], keys.t_cw[i][..., 0])
        s = s_x ^ (keys.s_cw[i] * t.unsqueeze(-1))
        t = t_x ^ (t * t_cw)
    return (1 - 2 * party) * (words_to_ring(s[..., :2]) + t * keys.last_cw)
