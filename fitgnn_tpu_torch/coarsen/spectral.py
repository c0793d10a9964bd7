"""Spectral machinery for coarsening: bottom-K Laplacian eigenbasis and
smoothed test vectors.

Replaces the reference's ARPACK usage (``coarsening_utils.py:83-96``) and
Gauss–Seidel/Jacobi relaxation (``:814-854``).  The eigensolve uses the
shift-invert-free trick: bottom-K of L = top-K of (offset·I − L) with
offset = 2·max(deg), which keeps ARPACK in its fast LM mode.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph


LOBPCG_NODE_THRESHOLD = 100_000   # above this, ARPACK's Lanczos sweeps over
                                  # the full operator get slow; blocked
                                  # LOBPCG with a Jacobi preconditioner scales


def bottom_k_eigen(g: LapGraph, k: int, tol: float = 1e-5,
                   method: str = "auto"):
    """Bottom-k eigenpairs of the combinatorial Laplacian. Returns (lk, Uk)
    with ascending eigenvalues.

    ``method``: "dense" | "arpack" | "lobpcg" | "auto" (dense for tiny
    graphs, ARPACK in shift-free LM mode up to ``LOBPCG_NODE_THRESHOLD``
    nodes, preconditioned LOBPCG beyond — the products-scale fallback)."""
    n = g.N
    k = min(k, n - 1) if n > 1 else 1
    if method == "dense" or (method == "auto" and n <= max(3 * k, 60)):
        lk, Uk = np.linalg.eigh(g.L.toarray())
        return lk[:k], Uk[:, :k]
    if method == "lobpcg" or (method == "auto"
                              and n > LOBPCG_NODE_THRESHOLD):
        return _bottom_k_lobpcg(g, k, tol)
    offset = 2.0 * float(g.dw.max()) if g.dw.size else 2.0
    T = offset * sp.eye(n, format="csr") - g.L
    # deterministic ARPACK start vector (the default draws from numpy's
    # global RNG, making results order-dependent across calls)
    v0 = np.random.default_rng(42).standard_normal(n)
    lam, U = spla.eigsh(T, k=k, which="LM", tol=tol, v0=v0)
    lk = (offset - lam)[::-1]
    Uk = U[:, ::-1]
    return lk, Uk


def _bottom_k_lobpcg(g: LapGraph, k: int, tol: float = 1e-5,
                     maxiter: int = 200):
    """Blocked LOBPCG for the bottom-k eigenpairs at products scale: a
    deterministic random block, Jacobi (inverse-degree) preconditioning, and
    a final ascending sort.  O(iters · k · nnz) — no full Lanczos basis."""
    n = g.N
    L = (g.L + 1e-8 * sp.eye(n, format="csr")).tocsr()
    deg = np.asarray(g.dw, dtype=np.float64)
    dinv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-12), 1.0)
    M = sp.diags(dinv).tocsr()    # Jacobi preconditioner
    rng = np.random.default_rng(42)
    guard = max(k // 2, 4)           # extra block vectors: the edge of the
    kb = min(k + guard, n - 1)       # block converges slowest
    X = rng.standard_normal((n, kb))
    X[:, 0] = 1.0 / np.sqrt(n)       # seed the known constant eigenvector
    import warnings
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")  # tail-of-block accuracy warnings
        lam, U = spla.lobpcg(L, X, M=M, tol=tol, maxiter=maxiter,
                             largest=False)
    order = np.argsort(lam)[:k]
    return lam[order], U[:, order]


def variation_basis(g: LapGraph, k: int):
    """A = Uk · diag(λ^-1/2) — the subspace whose variation coarsening must
    preserve (zero eigenvalues give zero columns)."""
    lk, Uk = bottom_k_eigen(g, k)
    mask = lk < 1e-10
    safe = np.where(mask, 1.0, lk)
    lsinv = safe ** -0.5
    lsinv[mask] = 0.0
    return Uk * lsinv[None, :]


def propagate_basis(B: np.ndarray, iC: sp.spmatrix, L_coarse: sp.spmatrix):
    """Carry the variation basis one level down: B ← iC·B, then re-orthogonalize
    against the coarse Laplacian (reference ``coarsening_utils.py:98-106``)."""
    B = iC @ B
    M = B.T @ (L_coarse @ B)
    # M is symmetric PSD up to numerics
    d, V = np.linalg.eigh((M + M.T) * 0.5)
    mask = d <= 1e-12
    safe = np.where(mask, 1.0, d)
    dinvsqrt = safe ** -0.5
    dinvsqrt[mask] = 0.0
    return B @ (V * dinvsqrt[None, :])


def chebyshev_filter(L: sp.spmatrix, X: np.ndarray, lambda_cut: float,
                     lmax: float, order: int = 50) -> np.ndarray:
    """Low-pass graph filter h(λ)=1_{λ≤cut} applied via an order-``order``
    Chebyshev polynomial of L (first-party replacement for the pygsp
    Chebyshev filter the reference uses, ``coarsening_utils.py:851-854``)."""
    lmax = max(float(lmax), 1e-12)
    nq = order + 1
    tq = np.cos(np.pi * (np.arange(nq) + 0.5) / nq)       # Cheb nodes
    lam_q = lmax * (tq + 1.0) / 2.0
    hq = (lam_q <= lambda_cut).astype(np.float64)
    # coefficients c_k = (2/nq) Σ_q h(λ_q) cos(k·acos(t_q))
    ks = np.arange(order + 1)
    c = (2.0 / nq) * (np.cos(np.outer(ks, np.arccos(tq))) @ hq)

    # T_k recurrence on the scaled operator Ls = 2L/lmax − I
    def ls(v):
        return (2.0 / lmax) * (L @ v) - v

    t_prev = X
    t_cur = ls(X)
    out = 0.5 * c[0] * t_prev + c[1] * t_cur
    for k in range(2, order + 1):
        t_next = 2.0 * ls(t_cur) - t_prev
        out = out + c[k] * t_next
        t_prev, t_cur = t_cur, t_next
    return out


def smoothed_vectors(g: LapGraph, num_vectors: int, method: str = "JC",
                     iterations: int = 20, seed: int = 0,
                     lambda_cut: float = 0.1,
                     cheby_order: int = 50) -> np.ndarray:
    """Relaxed random test vectors: 'JC' (damped Jacobi), 'GS'
    (Gauss–Seidel), or 'Chebychev' (order-50 low-pass filter below
    ``lambda_cut``, reference spelling kept).

    Matches the reference's generator semantics (``:814-854``): X ~ N(0,1)/√N,
    JC: x ← ½x + ½ D⁻¹(D−L)x ; GS: x ← −(L_lower+D)⁻¹ L_upper x.
    """
    rng = np.random.default_rng(seed)
    n = g.N
    X = rng.standard_normal((n, num_vectors)) / np.sqrt(n)
    L = g.L.tocsr()
    if method in ("Chebychev", "Chebyshev", "cheby"):
        lmax = 2.0 * float(g.dw.max()) if g.dw.size else 2.0  # λmax(L) bound
        return chebyshev_filter(L, X, lambda_cut, lmax, order=cheby_order)
    if method in ("JC", "Jacobi"):
        deg = g.dw.astype(np.float64)
        with np.errstate(divide="ignore"):
            deginv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-300), 0.0)
        # M = D^-1 (D - L) = I - D^-1 L  (W row-normalized)
        M = sp.diags(deginv) @ (sp.diags(deg) - L)
        for _ in range(iterations):
            X = 0.5 * X + 0.5 * (M @ X)
        return X
    if method in ("GS", "Gauss-Seidel"):
        # isolated nodes give a singular lower factor; regularize their
        # diagonal (their relaxed value is irrelevant — no incident edges)
        diag = L.diagonal()
        if np.any(diag == 0):
            L = L + sp.diags(np.where(diag == 0, 1.0, 0.0))
        upper = sp.triu(L, 1, format="csr")
        lower_diag = sp.csr_matrix(sp.triu(L, 0, format="csc").T)
        for j in range(num_vectors):
            x = X[:, j]
            for _ in range(iterations):
                rhs = upper @ x
                x = -spla.spsolve_triangular(lower_diag, rhs, lower=True)
            X[:, j] = x
        return X
    raise ValueError(f"unknown smoother {method!r}")
