"""Pseudo-random zero shares (PRZS).

Port of ``primia_tpu/mpc/przs.py``. A ring of seeded generators: seed i
is known to parties i and i + 1 (mod n), and party i's share is
``PRG(seed_i) - PRG(seed_{i-1})``, so the shares sum to zero without
communication. The replicated 3-party sharing (``mpc/replicated.py``)
masks with them when it reshares after a product. The n shares come out
as one tensor with the party axis in front.
"""

from __future__ import annotations

from typing import List

import torch

from primia_tpu_torch.mpc import shares as S


def setup(gen: torch.Generator, n_parties: int) -> List[torch.Generator]:
    """The seed ring: n generators on ``gen``'s device, seeded from draws
    of ``gen``; generator i is known to parties i and (i + 1) mod n."""
    seeds = torch.randint(0, 1 << 62, (n_parties,), generator=gen, device=gen.device).tolist()
    return [torch.Generator(device=gen.device).manual_seed(s) for s in seeds]


def zero_shares(ring: List[torch.Generator], shape) -> torch.Tensor:
    """(n_parties, *shape) int64 values summing to 0 mod 2^64: each
    generator's draw enters once at its owner and once, negated, at the
    owner's ring neighbour."""
    streams = torch.stack([S.rand_ring(g, shape) for g in ring])
    return streams - streams.roll(1, dims=0)
