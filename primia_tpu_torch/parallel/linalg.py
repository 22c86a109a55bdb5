"""Privacy-preserving distributed linear algebra and regression.

Port of ``primia_tpu/parallel/linalg.py`` (reference
``syft/frameworks/torch/linalg/``: ``EncryptedLinearRegression``,
``DASH`` and the distributed ``qr`` / ``inv_sym``). A "worker" is a node
shard. Each node's Gram and cross products are computed on its own rows;
the sum across nodes goes through fixed-point encoding at 24 fractional
bits, additive shares over Z_{2^64} (``mpc/fixed.py``, ``mpc/shares.py``),
a sum in share space and one reveal, as secure FedAvg does, so only the
aggregated second moments are revealed. The p x p solve runs in the clear
on the aggregate, as in the reference.

The distributed QR is a CholeskyQR: R from the securely aggregated Gram
matrix, Q_i = X_i R^-1 kept on each node.

Everything runs in float64 (the JAX package turns x64 on) on the device
given, ``"cuda"`` by default (it raises without a card) or ``"cpu"``;
shares are drawn from an explicit ``torch.Generator`` on that device.
Since the shares cancel exactly in the ring, the revealed sums do not
depend on the draws.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from primia_tpu_torch import resolve_device
from primia_tpu_torch.mpc import fixed
from primia_tpu_torch.mpc import shares as S

# second moments of standardized regressors easily exceed the default
# 16-bit activation scaling; 24 fractional bits keeps ~1e-7 resolution
# with plenty of ring headroom for p x p sums
_LINALG_FRAC_BITS = 24


def _secure_sum(gen: torch.Generator, per_node: Sequence[torch.Tensor],
                frac_bits: int = _LINALG_FRAC_BITS) -> torch.Tensor:
    """sum_i m_i without revealing any m_i: each node's matrix encoded in
    fixed point, split into 2-party additive shares drawn from ``gen``,
    summed in share space; only the total is revealed (float64)."""
    acc = None
    for m in per_node:
        sh = S.share(gen, fixed.encode(m, frac_bits))
        acc = sh if acc is None else S.add(acc, sh)
    return fixed.decode(S.reconstruct(acc), frac_bits)


def inv_sym(m: torch.Tensor) -> torch.Tensor:
    """Symmetric-positive-definite inverse via Cholesky (reference
    ``operations.py:inv_sym`` uses an LDL factorization)."""
    L = torch.linalg.cholesky(m)
    eye = torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.T @ Linv


def cholesky_qr(gen: torch.Generator, X_nodes: Sequence[torch.Tensor]):
    """Distributed reduced QR of the row-stacked node matrices.

    R = chol(sum_i X_i^T X_i)^T via secure aggregation; each node keeps
    its Q_i = X_i R^-1 (Q never crosses nodes). Returns (Q_nodes, R).
    Reference: ``operations.py:qr`` over pointers."""
    gram = _secure_sum(gen, [x.T @ x for x in X_nodes])
    R = torch.linalg.cholesky(gram).T
    eye = torch.eye(R.shape[0], dtype=R.dtype, device=R.device)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return [x @ Rinv for x in X_nodes], R


def _normal_sf(z: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.special.erfc(z / math.sqrt(2.0))


class RegressionSummary(NamedTuple):
    coef: np.ndarray
    std_errors: np.ndarray
    p_values: np.ndarray
    sigma2: float
    n_obs: int


def _f64(arrays, device) -> List[torch.Tensor]:
    return [torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)
            for a in arrays]


def _with_intercept(nodes: List[torch.Tensor]) -> List[torch.Tensor]:
    return [torch.cat([torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device), x], 1)
            for x in nodes]


class EncryptedLinearRegression:
    """OLS over node-sharded (X, y) with MPC-aggregated moments.

    Mirrors the reference's API (``lr.py:19-303``): ``fit`` over lists of
    per-node arrays, then ``coef_`` / ``intercept_`` / ``predict`` /
    ``summarize``. ``crypto`` gates MPC vs plain aggregation of the moment
    matrices, as the reference's flag does."""

    def __init__(self, fit_intercept: bool = True, crypto: bool = True, seed: int = 0,
                 device="cuda"):
        self.fit_intercept = fit_intercept
        self.crypto = crypto
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.summary: Optional[RegressionSummary] = None

    def fit(self, X_nodes: List, y_nodes: List):
        if len(X_nodes) != len(y_nodes) or not X_nodes:
            raise ValueError("need matching non-empty per-node X and y lists")
        X_nodes = _f64(X_nodes, self.device)
        y_nodes = [y.reshape(-1) for y in _f64(y_nodes, self.device)]
        p = X_nodes[0].shape[1]
        if any(x.shape[1] != p for x in X_nodes):
            raise ValueError("inconsistent feature counts across nodes")
        if any(x.shape[0] != y.shape[0] for x, y in zip(X_nodes, y_nodes)):
            raise ValueError("X/y row mismatch on a node")
        if self.fit_intercept:
            X_nodes = _with_intercept(X_nodes)

        # per-node sufficient statistics, packed so ONE secure sum
        # reveals exactly [X^T X | X^T y | y^T y] and nothing else
        stats = [
            torch.cat([
                torch.cat([x.T @ x, (x.T @ y)[:, None]], 1),
                torch.cat([(x.T @ y)[None, :], (y @ y).reshape(1, 1)], 1),
            ], 0)
            for x, y in zip(X_nodes, y_nodes)
        ]
        total = _secure_sum(self._gen, stats) if self.crypto else sum(stats)
        d = p + (1 if self.fit_intercept else 0)
        xtx, xty, yty = total[:d, :d], total[:d, d], float(total[d, d])
        n = sum(int(x.shape[0]) for x in X_nodes)

        xtx_inv = inv_sym(xtx)
        beta = xtx_inv @ xty
        rss = yty - 2.0 * beta @ xty + beta @ xtx @ beta
        dof = max(n - d, 1)
        sigma2 = float(rss) / dof
        se = torch.sqrt(sigma2 * torch.diag(xtx_inv))
        pvals = 2.0 * _normal_sf(torch.abs(beta / se))

        self.summary = RegressionSummary(beta.cpu().numpy(), se.cpu().numpy(),
                                         pvals.cpu().numpy(), sigma2, n)
        return self

    @property
    def coef_(self):
        b = self.summary.coef
        return b[1:] if self.fit_intercept else b

    @property
    def intercept_(self):
        return float(self.summary.coef[0]) if self.fit_intercept else 0.0

    def predict(self, X):
        X = _f64([X], self.device)[0]
        coef = torch.as_tensor(self.coef_, dtype=torch.float64, device=self.device)
        return (X @ coef + self.intercept_).cpu().numpy()

    def summarize(self) -> str:
        """Console coefficient table (reference ``summarize``)."""
        s = self.summary
        names = (["intercept"] if self.fit_intercept else []) + [
            f"x{i}" for i in range(len(s.coef) - (1 if self.fit_intercept else 0))]
        lines = [f"EncryptedLinearRegression  n={s.n_obs}  sigma^2={s.sigma2:.6g}",
                 f"{'term':>10} {'coef':>12} {'std err':>12} {'p-value':>10}"]
        for nm, c, e, pv in zip(names, s.coef, s.std_errors, s.p_values):
            lines.append(f"{nm:>10} {c:>12.6f} {e:>12.6f} {pv:>10.4g}")
        return "\n".join(lines)


class DASH:
    """Covariate-adjusted association scan (reference ``lr.py:305-567``).

    For each candidate regressor column x_j (e.g. a SNP) test its effect
    on y after projecting out shared covariates C: residualize through the
    distributed CholeskyQR of C, then per-column OLS on the residuals, all
    cross-node reductions through the same secure sum."""

    def __init__(self, fit_intercept: bool = True, crypto: bool = True, seed: int = 0,
                 device="cuda"):
        self.fit_intercept = fit_intercept
        self.crypto = crypto
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def fit(self, X_nodes: List, C_nodes: List, y_nodes: List):
        X_nodes = _f64(X_nodes, self.device)
        C_nodes = _f64(C_nodes, self.device)
        y_nodes = [y.reshape(-1) for y in _f64(y_nodes, self.device)]
        if self.fit_intercept:
            C_nodes = _with_intercept(C_nodes)

        Q_nodes, _ = cholesky_qr(self._gen, C_nodes)

        # residualize locally: r = v - Q (Q^T v), with Q^T v securely
        # summed across nodes (Q's columns are orthonormal globally)
        def residualize(V_nodes):
            qtv = [q.T @ v for q, v in zip(Q_nodes, V_nodes)]
            total = _secure_sum(self._gen, qtv) if self.crypto else sum(qtv)
            return [v - q @ total for q, v in zip(Q_nodes, V_nodes)]

        Xr = residualize(X_nodes)
        yr = residualize(y_nodes)

        # per-column scan moments: diag(X^T X), X^T y, y^T y in one pack
        packed = [torch.cat([torch.sum(x * x, 0), x.T @ y, (y @ y).reshape(1)])
                  for x, y in zip(Xr, yr)]
        total = _secure_sum(self._gen, packed) if self.crypto else sum(packed)
        m = X_nodes[0].shape[1]
        sxx, sxy, syy = total[:m], total[m:2 * m], float(total[2 * m])

        n = sum(int(x.shape[0]) for x in X_nodes)
        dof = max(n - C_nodes[0].shape[1] - 1, 1)
        beta = sxy / sxx
        rss = torch.clamp(syy - beta * sxy, min=0.0)
        se = torch.sqrt(rss / dof / sxx)
        self.coef_ = beta.cpu().numpy()
        self.std_errors_ = se.cpu().numpy()
        self.p_values_ = (2.0 * _normal_sf(torch.abs(beta / se))).cpu().numpy()
        return self

    def get_coeff(self):
        return self.coef_

    def get_standard_errors(self):
        return self.std_errors_

    def get_p_values(self):
        return self.p_values_
