"""Local-variation contraction (Loukas-style spectral coarsening).

Candidate families: closed neighborhoods, edges, or maximal cliques.  Each
candidate set S is scored by how much contracting it perturbs the preserved
subspace A:

    L_S   = diag(2·deg[S] − W_S·1) − W_S      (boundary-doubled local Laplacian)
    B     = (I − 11ᵀ/|S|) · A[S]              (component ⟂ to constant)
    cost  = ‖Bᵀ L_S B‖₂ / (|S| − 1)

(semantics per reference ``coarsening_utils.py:483-650``; implementation is
fresh: vectorized edge costs, stdlib heap with lazy re-insertion instead of a
SortedList, scipy CSR row slicing).
"""

from __future__ import annotations

import heapq
from typing import List

import numpy as np
import scipy.sparse as sp

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen.matching import matching_greedy, matching_optimal


def maximal_cliques(W: sp.spmatrix) -> List[List[int]]:
    """Every maximal clique of the graph whose edges are ``W``'s stored
    entries (self loops ignored), each as a list of node ids.

    Bron–Kerbosch with Tomita's pivot, unrolled onto a stack: the
    algorithm of networkx's ``find_cliques`` on
    ``from_scipy_sparse_array(W)``, in the same order.  The order matters:
    the greedy selection below breaks cost ties by candidate index.  So
    each neighbour set is filled in networkx's adjacency order (a
    neighbour below the node in ascending order, one above in the order
    of the node's CSR row), and the search runs the same Python set
    operations, whose iteration order follows from that.
    """
    W = sp.csr_matrix(W)
    n = W.shape[0]
    if n == 0:
        return []
    indptr, indices = W.indptr, W.indices
    nbr = [dict() for _ in range(n)]       # insertion-ordered neighbours
    for u in range(n):
        for v in indices[indptr[u]:indptr[u + 1]].tolist():
            nbr[u][v] = None
            nbr[v][u] = None
    adj = {u: {v for v in nbr[u] if v != u} for u in range(n)}

    out: List[List[int]] = []
    Q: list = []
    cand = set(range(n))
    subg = cand.copy()
    stack = []
    Q.append(None)
    u = max(subg, key=lambda u: len(cand & adj[u]))
    ext_u = cand - adj[u]
    try:
        while True:
            if ext_u:
                q = ext_u.pop()
                cand.remove(q)
                Q[-1] = q
                adj_q = adj[q]
                subg_q = subg & adj_q
                if not subg_q:
                    out.append(Q[:])
                else:
                    cand_q = cand & adj_q
                    if cand_q:
                        stack.append((subg, cand, ext_u))
                        Q.append(None)
                        subg = subg_q
                        cand = cand_q
                        u = max(subg, key=lambda u: len(cand & adj[u]))
                        ext_u = cand - adj[u]
            else:
                Q.pop()
                subg, cand, ext_u = stack.pop()
    except IndexError:
        pass
    return out


def _set_cost(W_csr: sp.csr_matrix, deg: np.ndarray, A: np.ndarray,
              nodes: np.ndarray) -> float:
    nc = len(nodes)
    if nc < 2:
        return np.inf
    Ws = W_csr[nodes][:, nodes].toarray()
    Ls = np.diag(2.0 * deg[nodes] - Ws.sum(1)) - Ws
    Bs = A[nodes] - A[nodes].mean(0, keepdims=True)
    M = Bs.T @ Ls @ Bs
    return float(np.linalg.norm(M, 2)) / (nc - 1)


def _edge_costs(g: LapGraph, A: np.ndarray):
    """Vectorized local-variation cost for every edge (i<j)."""
    i, j, w = g.edge_list()
    deg = g.dw
    di = 2.0 * deg[i] - w
    dj = 2.0 * deg[j] - w
    # B rows: (A[i]-A[j])/2 and (A[j]-A[i])/2 → Bᵀ L B has closed form:
    # with u = (A[i]-A[j])/2, BᵀLB = (di + dj + 2w) uᵀu  → spectral norm =
    # (di+dj+2w)/4 · ‖A[i]-A[j]‖²
    diff = A[i] - A[j]
    sq = np.sum(diff * diff, axis=1)
    return i, j, (di + dj + 2.0 * w) * 0.25 * sq


def contract_variation_edges(g: LapGraph, A: np.ndarray, r: float,
                             algorithm: str = "greedy") -> List[np.ndarray]:
    i, j, costs = _edge_costs(g, A)
    edges = np.stack([i, j])
    if algorithm == "optimal":
        return matching_optimal(g.N, edges, costs, r)
    return matching_greedy(g.N, edges, -costs, r)


def contract_variation_linear(g: LapGraph, A: np.ndarray, r: float,
                              mode: str = "neighborhood") -> List[np.ndarray]:
    """Greedy min-cost independent family selection (heap + lazy repair)."""
    W_csr = g.W
    deg = g.dw

    if "neighborhood" in mode:
        candidates = g.neighborhoods()
    elif "cliques" in mode:
        candidates = [np.array(c, dtype=np.int64)
                      for c in maximal_cliques(g.W)]
    elif "edges" in mode:
        i, j, _ = g.edge_list()
        candidates = [np.array([a, b], dtype=np.int64) for a, b in zip(i, j)]
    else:
        raise ValueError(f"unknown variation mode {mode!r}")

    heap = []
    for idx, nodes in enumerate(candidates):
        if len(nodes) >= 2:
            heapq.heappush(
                heap, (_set_cost(W_csr, deg, A, nodes), idx, nodes))

    marked = np.zeros(g.N, dtype=bool)
    coarsening_list: List[np.ndarray] = []
    n_reduce = np.floor(r * g.N)
    tiebreak = len(candidates)
    while heap and n_reduce > 0:
        cost, _, nodes = heapq.heappop(heap)
        hit = marked[nodes]
        if not hit.any():
            gain = len(nodes) - 1
            if gain > n_reduce:
                continue  # would over-reduce
            marked[nodes] = True
            coarsening_list.append(nodes)
            n_reduce -= gain
        else:
            nodes = nodes[~hit]
            if len(nodes) > 1:  # re-insert the surviving subset, re-scored
                heapq.heappush(
                    heap,
                    (_set_cost(W_csr, deg, A, nodes), tiebreak, nodes))
                tiebreak += 1
    return coarsening_list
