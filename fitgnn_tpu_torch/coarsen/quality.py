"""Coarsening quality oracles — the acceptance metrics for the coarsening
stack (the reference computes these but never gates on them,
``coarsening_utils.py:257-351``; we use them as test gates, SURVEY §4.5).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen.spectral import bottom_k_eigen


def eigenvalue_errors(W: sp.spmatrix, C: sp.csr_matrix, kmax: int = 10
                      ) -> np.ndarray:
    """Relative errors |λ_k − λc_k| / λ_k between L and the projected coarse
    Laplacian Lc = C·L·Cᵀ (the comparison the reference's
    ``coarsening_quality`` makes, ``coarsening_utils.py:305-320``)."""
    g = LapGraph(W)
    n = C.shape[0]
    k = min(kmax, n - 1, g.N - 1)
    lk, _ = bottom_k_eigen(g, k)
    Lc = (C @ g.L @ C.T).toarray()
    lck = np.linalg.eigvalsh((Lc + Lc.T) * 0.5)[:k]
    lk = lk[:k]
    denom = np.where(np.abs(lk) < 1e-12, 1.0, lk)
    err = np.abs(lk - lck) / denom
    err[np.abs(lk) < 1e-12] = np.abs(lck[np.abs(lk) < 1e-12])
    return err


def subspace_angles(W: sp.spmatrix, C: sp.csr_matrix, kmax: int = 10
                    ) -> np.ndarray:
    """sin-θ-style subspace error between the bottom-k eigenvectors of L and
    the lifted eigenvectors of Lc = C·L·Cᵀ (reference ``error_sintheta``,
    ``coarsening_utils.py:339-346``): for each k, the Frobenius energy of the
    angle-matrix block coupling the preserved and discarded subspaces."""
    g = LapGraph(W)
    n = C.shape[0]
    k = min(kmax, n - 1, g.N - 1)
    _, U = bottom_k_eigen(g, k)
    Lc = (C @ g.L @ C.T).toarray()
    _, Uc = np.linalg.eigh((Lc + Lc.T) * 0.5)
    angle = U.T @ (C.T @ Uc)          # (k, n)
    out = np.zeros(k)
    for idx in range(1, k):
        out[idx] = np.linalg.norm(angle[: idx + 1, idx + 1:], ord="fro") ** 2
    return out


def rayleigh_preservation(W: sp.spmatrix, C: sp.csr_matrix,
                          Wc: sp.spmatrix, kmax: int = 10) -> np.ndarray:
    """For the bottom-k eigenvectors u of L: |R_c(Cu) − R(u)| / max(R(u), ε)
    where R is the Rayleigh quotient — how well the coarse graph preserves
    smooth signals' energy."""
    g, gc = LapGraph(W), LapGraph(Wc)
    k = min(kmax, gc.N - 1, g.N - 1)
    lk, Uk = bottom_k_eigen(g, k)
    out = np.zeros(k)
    for idx in range(k):
        u = Uk[:, idx]
        uc = C @ u
        nc = uc @ uc
        r_f = u @ (g.L @ u)
        r_c = (uc @ (gc.L @ uc)) / max(nc, 1e-12)
        out[idx] = abs(r_c - r_f) / max(abs(r_f), 1e-12)
    return out
