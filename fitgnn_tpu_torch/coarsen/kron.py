"""Kron reduction coarsening (Schur complement of the Laplacian).

Semantics per the reference's kron pipeline (``coarsening_utils.py:996-1218``,
pygsp ``kron_reduction``): pick the keep-set from the sign of the largest
Laplacian eigenvector, reduce L by the Schur complement

    L_c = L[V+,V+] − L[V+,V−] · L[V−,V−]⁻¹ · L[V−,V+]

and read the coarse weights off −offdiag(L_c).  Where the reference derives
the node→metanode map downstream by argmax over C columns
(``utils.py:170-180``), we assign each eliminated node to its most strongly
coupled kept neighbor — the same effective "strongest coupling" partition
without the dense pseudo-inverse.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph


def _largest_eigvec(L: sp.spmatrix) -> np.ndarray:
    n = L.shape[0]
    if n <= 64:
        w, v = np.linalg.eigh(L.toarray())
        return v[:, -1]
    v0 = np.random.default_rng(42).standard_normal(n)
    _, v = spla.eigsh(L.tocsc(), k=1, which="LM", tol=1e-4, v0=v0)
    return v[:, 0]


def kron_reduce_once(g: LapGraph):
    """One kron level. Returns (parent, Wc) — parent maps fine→coarse ids."""
    L = g.L.tocsc()
    n = g.N
    u = _largest_eigvec(L)
    keep = np.where(u >= 0)[0]
    if len(keep) in (0, n):  # degenerate split: keep the larger half by degree
        order = np.argsort(-g.dw)
        keep = np.sort(order[: max(n // 2, 1)])
    drop = np.setdiff1d(np.arange(n), keep)

    # Schur complement
    L_kk = L[keep][:, keep]
    L_kd = L[keep][:, drop]
    L_dd = L[drop][:, drop].tocsc()
    if len(drop):
        # L_dd is an M-matrix (strictly diagonally dominant for connected
        # graphs with boundary), solve column block
        X = spla.spsolve(L_dd, L_kd.T.toarray() if len(drop) < 2000
                         else L_kd.T.tocsc())
        if sp.issparse(X):
            Lc = (L_kk - L_kd @ X).toarray()
        else:
            Lc = L_kk.toarray() - L_kd.toarray() @ X
    else:
        Lc = L_kk.toarray()

    Wc = -Lc
    np.fill_diagonal(Wc, 0.0)
    Wc[Wc < 0] = 0.0  # numerical negatives
    Wc = (Wc + Wc.T) * 0.5

    # partition: kept → own coarse id; dropped → strongest kept neighbor
    parent = np.empty(n, dtype=np.int64)
    parent[keep] = np.arange(len(keep))
    if len(drop):
        coupling = -L[drop][:, keep].toarray()  # (n_drop, n_keep), ≥ 0 weights
        # fall back to nearest kept by any coupling; rows of all-zero coupling
        # (no kept neighbor) attach to coarse node 0
        parent[drop] = coupling.argmax(axis=1)
    return parent, sp.csr_matrix(Wc)


def kron_coarsen(g: LapGraph, n_target: int, max_levels: int = 10):
    """Multilevel kron reduction until ≤ n_target nodes."""
    parents = []
    cur = g
    for _ in range(max_levels):
        if cur.N <= n_target or cur.N <= 2:
            break
        parent, Wc = kron_reduce_once(cur)
        if Wc.shape[0] >= cur.N - 2:
            break
        parents.append(parent)
        cur = LapGraph(Wc)
    return parents, cur
