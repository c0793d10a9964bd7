"""Multilevel coarsening driver (host numpy/scipy, as the JAX package's
``coarsen/core.py``).

The counterpart of the reference's ``coarsen()``
(``coarsening_utils.py:18-182``): repeatedly contract the graph until the
target size is reached, composing per-level partitions into one final
node→metanode map.  Unlike the reference — which threads *two* mapping
representations through the pipeline (mapping_dict_list for variation
methods, C-nonzero argmax for the rest, ``utils.py:167-182``) — every method
here yields a partition, and the C matrix / coarse weights / metanode map all
derive from it through one code path (``project.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.coarsen import project
from fitgnn_tpu_torch.coarsen.kron import kron_coarsen
from fitgnn_tpu_torch.coarsen.matching import matching_greedy, matching_optimal
from fitgnn_tpu_torch.coarsen.proximity import PROXIMITY_FNS
from fitgnn_tpu_torch.coarsen.spectral import variation_basis, propagate_basis
from fitgnn_tpu_torch.coarsen.variation import (
    contract_variation_edges, contract_variation_linear,
)

METHODS = (
    "variation_neighborhoods", "variation_edges", "variation_cliques",
    "heavy_edge", "heavy_edge_degree", "algebraic_JC", "algebraic_GS",
    "affinity_GS", "min_expected_loss", "min_expected_gradient_loss",
    "rss", "rss_lanczos", "rss_cheby", "kron",
)

# variation_neighborhoods levels of more nodes take the native core
NATIVE_VARIATION_MIN_NODES = 3000


@dataclasses.dataclass
class CoarseningResult:
    parent: np.ndarray           # (N,) node → metanode id
    C: sp.csr_matrix             # (n, N) partial isometry
    Wc: sp.csr_matrix            # (n, n) coarse adjacency
    num_levels: int
    level_parents: List[np.ndarray]

    @property
    def num_coarse(self) -> int:
        return self.Wc.shape[0]


def coarsen(W: sp.spmatrix, r: float = 0.5,
            method: str = "variation_neighborhoods", K: int = 10,
            max_levels: int = 10, algorithm: str = "greedy",
            seed: int = 0) -> CoarseningResult:
    """Coarsen to n ≈ (1−r)·N nodes.  ``r`` is the *reduction* fraction."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; choose from {METHODS}")
    r = float(np.clip(r, 0.0, 0.999))
    g = LapGraph(W)
    N = g.N
    n_target = int(np.ceil((1.0 - r) * N))

    if method == "kron":
        parents, g_final = kron_coarsen(g, n_target, max_levels)
        return _result(N, parents, g_final)

    parents: List[np.ndarray] = []
    B: Optional[np.ndarray] = None
    iC_prev: Optional[sp.csr_matrix] = None
    cur = g
    for level in range(1, max_levels + 1):
        n = cur.N
        if n <= n_target or n <= 2:
            break
        r_cur = float(np.clip(1.0 - n_target / n, 0.0, 0.99))

        if method.startswith("variation"):
            if B is None:
                B = variation_basis(cur, min(K, max(n - 1, 1)))
            else:
                B = propagate_basis(B, iC_prev, cur.L)
            A = B
            if method == "variation_edges":
                sets = contract_variation_edges(cur, A, r_cur, algorithm)
            elif (method == "variation_neighborhoods"
                  and n > NATIVE_VARIATION_MIN_NODES):
                # the C++ core (same algorithm) above this size; the
                # Python loop below is its oracle
                from fitgnn_tpu_torch.coarsen.native_variation import (
                    variation_neighborhoods_native)
                sets = _parent_to_sets(
                    variation_neighborhoods_native(cur, A, r_cur))
            else:
                mode = method.split("_", 1)[1]  # neighborhoods | cliques
                sets = contract_variation_linear(cur, A, r_cur, mode=mode)
        else:
            fn = PROXIMITY_FNS[method]
            if method in ("heavy_edge", "heavy_edge_degree"):
                edges, prox, _ = fn(cur)
            else:
                edges, prox, _ = fn(cur, seed=seed)
            if algorithm == "optimal":
                costs = -prox
                costs -= costs.min() if costs.size else 0.0
                sets = matching_optimal(n, edges, costs, r_cur)
            else:
                sets = matching_greedy(n, edges, prox, r_cur)

        if not sets:
            break
        parent = project.partition_from_contractions(n, sets)
        nc = int(parent.max()) + 1
        if n - nc <= 2 and level > 1:
            break  # avoid piling levels for negligible reduction
        parents.append(parent)
        iC_prev = project.coarsening_matrix(parent)
        Wc = project.coarsen_weights(cur.W, parent)
        cur = LapGraph(Wc)
        if n - nc <= 2:
            break

    return _result(N, parents, cur)


def _parent_to_sets(parent: np.ndarray) -> List[np.ndarray]:
    """Non-singleton groups of a parent map as contraction sets."""
    order = np.argsort(parent, kind="stable")
    bounds = np.searchsorted(parent[order], np.arange(parent.max() + 2))
    return [order[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b - a > 1]


def _result(N: int, parents: List[np.ndarray], g_final: LapGraph
            ) -> CoarseningResult:
    if parents:
        parent = project.compose_partitions(parents)
    else:
        parent = np.arange(N, dtype=np.int64)
    C = project.coarsening_matrix(parent)
    return CoarseningResult(parent=parent, C=C, Wc=g_final.W,
                            num_levels=len(parents), level_parents=parents)
