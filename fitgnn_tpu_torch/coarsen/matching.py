"""Edge matchings for pairwise contraction.

* ``matching_greedy``  — sort edges by weight desc, take non-conflicting pairs
  until the target reduction is met (reference ``coarsening_utils.py:931-989``
  semantics, vectorized sort + boolean marking).
* ``matching_optimal`` — maximum-weight perfect-ish matching on the negated
  cost (the reference vendors a 945-line pure-Python port,
  ``maxWeightMatching.py``); prefers the first-party C++ blossom core
  (``native/blossom.cpp``, built with g++ into ``build/fitgnn_tpu_torch/``).
  The JAX package falls back to networkx's blossom when the library is
  unavailable or the instance is too large; the port has no networkx and
  raises instead.
"""

from __future__ import annotations

from typing import List

import numpy as np


def matching_greedy(num_nodes: int, edges: np.ndarray, weights: np.ndarray,
                    r: float) -> List[np.ndarray]:
    """Pick heaviest non-conflicting edges until n ≤ (1−r)·N."""
    order = np.argsort(-weights, kind="stable")
    s, t = edges[0][order], edges[1][order]
    marked = np.zeros(num_nodes, dtype=bool)
    matching: List[np.ndarray] = []
    target = int(np.floor(r * num_nodes))
    reduced = 0
    for a, b in zip(s, t):
        if reduced >= target:
            break
        if not marked[a] and not marked[b] and a != b:
            marked[a] = marked[b] = True
            matching.append(np.array([a, b], dtype=np.int64))
            reduced += 1
    return matching


def matching_optimal(num_nodes: int, edges: np.ndarray, costs: np.ndarray,
                     r: float) -> List[np.ndarray]:
    """Min-cost matching via blossom; keeps the r·N cheapest matched pairs.
    Runs the first-party C++ core (native/blossom.cpp), which stores the
    instance densely: more than ``native_blossom.MAX_NODES`` nodes raise
    ``NotImplementedError``."""
    costs = np.asarray(costs, dtype=np.float64)
    shift = costs.max() if costs.size else 0.0
    weights = shift - costs + 1.0   # maximize (positive) == minimize cost

    from fitgnn_tpu_torch.coarsen.native_blossom import \
        max_weight_matching_native
    mate = max_weight_matching_native(edges, weights, num_nodes,
                                      max_cardinality=True)
    cost_of = {}
    for (a, b), c in zip(edges.T, costs):
        key = (min(int(a), int(b)), max(int(a), int(b)))
        cost_of[key] = min(cost_of.get(key, np.inf), float(c))

    pairs = sorted(
        (cost_of[(u, int(v))], (u, int(v)))
        for u, v in enumerate(mate) if v > u)

    target = int(np.ceil(r * num_nodes))
    return [np.array(p, dtype=np.int64) for _, p in pairs[:target]]
