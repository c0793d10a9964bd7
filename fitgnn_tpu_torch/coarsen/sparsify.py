"""Spectral graph sparsification by effective-resistance sampling.

Counterpart of the reference's ``graph_sparsify`` (``coarsening_utils.py:
1221-1302``, Spielman–Srivastava): sample edges with probability proportional
to w_e·R_e (approximate effective resistance), reweight kept edges by 1/p_e.
Resistances are approximated from Jacobi-smoothed random projections (the
same smoother machinery as the proximity measures) instead of the reference's
dense pseudo-inverse — O(E·k) and scales to the large graphs this framework
targets.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen.spectral import smoothed_vectors


def approx_effective_resistance(g: LapGraph, num_vectors: int = 24,
                                iterations: int = 30, seed: int = 0
                                ) -> np.ndarray:
    """R_e ≈ ‖Z[i]−Z[j]‖² from smoothed random vectors (JL-style sketch of
    the Laplacian pseudo-inverse square root)."""
    i, j, _ = g.edge_list()
    Z = smoothed_vectors(g, num_vectors, method="JC", iterations=iterations,
                         seed=seed)
    diff = Z[i] - Z[j]
    r = np.sum(diff * diff, axis=1)
    return np.maximum(r, 1e-12)


def graph_sparsify(W: sp.spmatrix, epsilon: float = 0.3,
                   seed: int = 0) -> sp.csr_matrix:
    """Sparsify to ~O(N log N / ε²) edges while approximately preserving the
    Laplacian spectrum. Keeps the graph connected in expectation by always
    retaining a bounded number of samples per edge."""
    g = LapGraph(W)
    n = g.N
    if n < 3:
        return g.W
    i, j, w = g.edge_list()
    m = len(w)
    if m == 0:
        return g.W
    r_eff = approx_effective_resistance(g, seed=seed)
    pe = np.maximum(w * r_eff, 1e-12)
    pe = pe / pe.sum()
    q = int(np.ceil(4.0 * n * np.log(max(n, 2)) / (epsilon ** 2)))
    q = min(q, 40 * m)  # cap the work
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(q, pe)
    keep = counts > 0
    new_w = (counts[keep] * w[keep]) / (q * pe[keep])
    Wn = sp.csr_matrix((new_w, (i[keep], j[keep])), shape=(n, n))
    Wn = Wn + Wn.T
    return sp.csr_matrix(Wn)
