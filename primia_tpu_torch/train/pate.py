"""PATE privacy analysis (teacher-ensemble noisy-max epsilon accounting).

Port of ``primia_tpu/train/pate.py``, a copy: the accountant is host
numpy, nowhere near the device (reference ``syft/frameworks/torch/dp/
pate.py``, vendored from TF Privacy: the moments accountant for the
LNMax aggregator of Papernot et al. 2017). Each bound is evaluated over
the whole (queries x moments) grid in one pass, and ``perform_analysis``
returns ``(data_dependent_eps, data_independent_eps)`` for the given
``delta``, the same floats as the JAX package's on the same votes.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def compute_q_noisy_max(counts, noise_eps: float) -> float:
    """Upper bound on Pr[noisy argmax != true argmax] for Lap(1/eps)
    noise on each count (reference ``compute_q_noisy_max``): sum over
    runner-ups j of (gap_j + 2) / (4 e^{gap_j}) with
    gap_j = eps * (n_winner - n_j)."""
    counts = np.asarray(counts, np.float64)
    winner = int(np.argmax(counts))
    gap = noise_eps * (counts[winner] - counts)
    gap = np.delete(gap, winner)
    q = float(np.sum((gap + 2.0) / (4.0 * np.exp(gap))))
    return min(q, 1.0 - 1.0 / counts.size)


def logmgf_exact(q: float, priv_eps: float, l: float) -> float:
    """log E[exp(l * privacy-loss)] bound for an eps-DP mechanism whose
    outcome is non-optimal with probability q: min of the
    data-dependent two-term bound, the pure-eps bound eps*l, and the
    subgaussian bound eps^2 l (l+1) / 2 (reference ``logmgf_exact``)."""
    if q < 0.5:
        t = (1 - q) * ((1 - q) / (1 - math.exp(priv_eps) * q)) ** l \
            + q * math.exp(priv_eps * l)
        log_t = math.log(t) if t > 0 else priv_eps * l
    else:
        log_t = priv_eps * l
    return min(0.5 * priv_eps * priv_eps * l * (l + 1), log_t, priv_eps * l)


def logmgf_from_counts(counts, noise_eps: float, l: float) -> float:
    """One noisy-max query's moment bound; the mechanism is
    2*noise_eps-DP (one count up, another down)."""
    return logmgf_exact(compute_q_noisy_max(counts, noise_eps), 2.0 * noise_eps, l)


def sens_at_k(counts, noise_eps: float, l: float, k: int) -> float:
    """Local sensitivity of the moment bound at histogram distance k:
    shrink the winner/runner-up gap by k, then by one more, and take the
    bound's increase (reference ``sens_at_k``)."""
    if 0.5 * noise_eps * l > 1:
        return 0.0
    counts = np.asarray(sorted(counts, reverse=True), np.float64)
    if counts[0] < counts[1] + k:
        return 0.0
    moved = counts.copy()
    moved[0] -= k
    moved[1] += k
    val = logmgf_from_counts(moved, noise_eps, l)
    moved[0] -= 1
    moved[1] += 1
    return logmgf_from_counts(moved, noise_eps, l) - val


def smoothed_sens(counts, noise_eps: float, l: float, beta: float) -> float:
    """beta-smooth sensitivity: max_k e^{-beta k} * sens_at_k
    (Nissim-Raskhodnikova-Smith smoothing)."""
    best = sens_at_k(counts, noise_eps, l, 0)
    for k in range(1, int(np.max(counts)) + 1):
        s = sens_at_k(counts, noise_eps, l, k)
        best = max(best, math.exp(-beta * k) * s)
        if s == 0.0:
            break
    return best


def votes_to_counts(teacher_preds: np.ndarray, num_labels: int | None = None) -> np.ndarray:
    """(num_teachers, num_examples) label votes -> (num_examples,
    num_labels) histograms, one vectorized scatter-add (the reference's
    double Python loop)."""
    teacher_preds = np.asarray(teacher_preds, np.int64)
    if num_labels is None:
        num_labels = int(teacher_preds.max()) + 1
    n_teachers, n_examples = teacher_preds.shape
    counts = np.zeros((n_examples, num_labels), np.float64)
    np.add.at(counts, (np.arange(n_examples)[None, :], teacher_preds), 1.0)
    return counts


def perform_analysis(
    teacher_preds: np.ndarray,
    indices: np.ndarray,
    noise_eps: float,
    delta: float = 1e-5,
    moments: int = 8,
    beta: float = 0.09,
) -> Tuple[float, float]:
    """Epsilon for a student trained on noisy-max teacher aggregation.

    Args / returns match the reference ``perform_analysis``
    (``pate.py:203-283``): ``teacher_preds`` is (num_teachers,
    num_examples) of voted labels, ``indices`` the queried example ids,
    ``noise_eps`` the per-query Laplace parameter. Returns
    ``(data_dependent_eps, data_independent_eps)`` at ``delta``.
    """
    teacher_preds = np.asarray(teacher_preds, np.int64)
    indices = np.asarray(indices, np.int64)
    num_examples = teacher_preds.shape[1]
    if indices.size and (indices.min() < 0 or indices.max() >= num_examples):
        raise ValueError("indices out of range of teacher_preds examples")

    counts_mat = votes_to_counts(teacher_preds)
    l_list = 1.0 + np.arange(moments)

    # data-dependent: per queried example, q from its vote histogram
    qs = np.array([compute_q_noisy_max(counts_mat[i], noise_eps) for i in indices])
    total_log_mgf = np.array([
        sum(logmgf_exact(q, 2.0 * noise_eps, l) for q in qs) for l in l_list
    ])
    eps_dep = float(np.min((total_log_mgf - math.log(delta)) / l_list))

    # data-independent: every query charged the worst case (q = 1)
    ind_log_mgf = num_examples * np.array(
        [logmgf_exact(1.0, 2.0 * noise_eps, l) for l in l_list])
    eps_ind = float(np.min((ind_log_mgf - math.log(delta)) / l_list))

    return eps_dep, eps_ind
