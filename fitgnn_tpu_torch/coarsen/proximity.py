"""Edge proximity measures for multigrid-style pairwise coarsening.

Vectorized first-party implementations of the measures the reference exposes
at the CLI (``coarsening_utils.py:658-811``): heavy_edge, algebraic_JC
(Jacobi-smoothed), affinity_GS (Gauss–Seidel-smoothed).  Larger proximity ⇒
contract first.
"""

from __future__ import annotations

import numpy as np

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen.spectral import smoothed_vectors


def heavy_edge(g: LapGraph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """proximity[e] = w_e / max(wmax[i], wmax[j]) — normalized heavy-edge."""
    i, j, w = g.edge_list()
    wmax = np.asarray(g.W.max(axis=0).todense()).ravel() + 1e-5
    prox = w / np.maximum(wmax[i], wmax[j])
    return np.stack([i, j]), prox, w


def algebraic_jc(g: LapGraph, num_vectors: int = 10, iterations: int = 20,
                 seed: int = 0):
    """Algebraic distance: prox[e] = min_k 1/max((x_k[i]−x_k[j])², 1e-6)."""
    i, j, w = g.edge_list()
    X = smoothed_vectors(g, num_vectors, method="JC", iterations=iterations,
                         seed=seed)
    diff2 = (X[i] - X[j]) ** 2                      # (E, K)
    prox = (1.0 / np.maximum(diff2, 1e-6)).min(axis=1)
    return np.stack([i, j]), prox, w


def affinity_gs(g: LapGraph, num_vectors: int = 10, iterations: int = 1,
                seed: int = 0):
    """Ruge–Stüben-style affinity from GS-relaxed vectors, normalized by each
    endpoint's strongest affinity."""
    i, j, w = g.edge_list()
    X = smoothed_vectors(g, num_vectors, method="GS", iterations=iterations,
                         seed=seed)
    dots = np.sum(X[i] * X[j], axis=1) ** 2
    norms = np.sum(X * X, axis=1)                   # (N,) squared 2-norms
    aff = dots / np.maximum(norms[i] * norms[j], 1e-30)
    # per-node max affinity over incident edges
    node_max = np.zeros(g.N)
    np.maximum.at(node_max, i, aff)
    np.maximum.at(node_max, j, aff)
    prox = aff / np.maximum(node_max[i] * node_max[j], 1e-30)
    return np.stack([i, j]), prox, w


def heavy_edge_degree(g: LapGraph):
    """prox[e] = deg_i + deg_j + 2·w_e (reference ``:733-736``)."""
    i, j, w = g.edge_list()
    deg = np.asarray(g.dw)
    return np.stack([i, j]), deg[i] + deg[j] + 2.0 * w, w


def _bottom_k(g: LapGraph, K: int, lanczos: bool):
    from fitgnn_tpu_torch.coarsen.spectral import bottom_k_eigen
    lk, U = bottom_k_eigen(g, K, tol=1e-2 if lanczos else 1e-5)
    return lk, U


def algebraic_gs(g: LapGraph, num_vectors: int = 10, iterations: int = 1,
                 seed: int = 0):
    """Algebraic distance over GS-relaxed vectors (reference ``:796-803``)."""
    i, j, w = g.edge_list()
    X = smoothed_vectors(g, num_vectors, method="GS", iterations=iterations,
                         seed=seed)
    diff2 = (X[i] - X[j]) ** 2
    prox = (1.0 / np.maximum(diff2, 1e-6)).min(axis=1)
    return np.stack([i, j]), prox, w


def min_expected_loss(g: LapGraph, K: int = 10, gradient: bool = False,
                      seed: int = 0):
    """Σ_{k=1..K-1} (x_k[i]−x_k[j])² (optionally degree-weighted) over the
    bottom-K Lanczos eigenvectors; SMALL sums are good so the sign is
    flipped (reference ``:737-753,806-808``)."""
    i, j, w = g.edge_list()
    _, X = _bottom_k(g, K, lanczos=True)
    diff2 = (X[i, 1:] - X[j, 1:]) ** 2                # (E, K-1)
    if gradient:
        deg = np.asarray(g.dw)
        diff2 = diff2 * (deg[i] + deg[j] + 2.0 * w)[:, None]
    return np.stack([i, j]), -diff2.sum(axis=1), w


def rss(g: LapGraph, K: int = 10, variant: str = "exact", seed: int = 0,
        cheby_order: int = 50):
    """Relaxation ensuring the first-K eigenspaces stay aligned
    (reference ``:755-795``): per-edge cost Σ_k (Δx_k)²·s_e/λ_k with
    s_e=(deg_i+deg_j+2w)/4; negated (small cost ⇒ contract first).

    ``variant``: "exact" (bottom-K eigenpairs), "lanczos" (low-tol
    eigenpairs, the reference's extra −λ_k offset in s_e), or "cheby"
    (Chebyshev-filtered random vectors with Rayleigh-quotient λ).
    """
    i, j, w = g.edge_list()
    deg = np.asarray(g.dw)
    s_e = (deg[i] + deg[j] + 2.0 * w) / 4.0           # (E,)
    if variant in ("exact", "lanczos"):
        lam, X = _bottom_k(g, K, lanczos=variant == "lanczos")
        X, lam = X[:, 1:], lam[1:]
        if variant == "lanczos":
            offs = s_e[:, None] - lam[None, :]        # s_e − 0.5(λ+λ)
        else:
            offs = np.broadcast_to(s_e[:, None], (len(i), len(lam)))
        diff2 = (X[i] - X[j]) ** 2
        cost = (diff2 * offs / np.maximum(lam[None, :], 1e-12)).sum(axis=1)
    elif variant == "cheby":
        lam_all, _ = _bottom_k(g, min(K + 2, max(g.N - 1, 1)), lanczos=True)
        cut = lam_all[min(K + 1, len(lam_all) - 1)]
        X = smoothed_vectors(g, K, method="Chebychev", seed=seed,
                             lambda_cut=float(cut), cheby_order=cheby_order)
        lam = np.einsum("nk,nk->k", X, g.L @ X)       # Rayleigh per vector
        diff2 = (X[i] - X[j]) ** 2
        cost = (diff2 * s_e[:, None]
                / np.maximum(lam[None, :], 1e-12)).sum(axis=1)
    else:
        raise ValueError(f"unknown rss variant {variant!r}")
    return np.stack([i, j]), -cost, w


PROXIMITY_FNS = {
    "heavy_edge": heavy_edge,
    "heavy_edge_degree": heavy_edge_degree,
    "algebraic_JC": algebraic_jc,
    "algebraic_GS": algebraic_gs,
    "affinity_GS": affinity_gs,
    "min_expected_loss": min_expected_loss,
    "min_expected_gradient_loss":
        lambda g, **kw: min_expected_loss(g, gradient=True, **kw),
    "rss": rss,
    "rss_lanczos": lambda g, **kw: rss(g, variant="lanczos", **kw),
    "rss_cheby": lambda g, **kw: rss(g, variant="cheby", **kw),
}
