"""Coarsening/projection matrices and their action.

The whole coarsening output is determined by a *partition* (node → supernode).
From a partition we build:

* ``C``  (n×N, rows 1/√|S_k|)  — partial isometry; features project as
  ``Xc = C·X`` (reference semantics, ``utils.py:738``).
* ``P``  = C.^2 (rows 1/|S_k|) — averaging projector; ``coarsen_vector``.
* membership M (N×n binary)     — ``Wc = Mᵀ W M`` (summed contraction, then
  zero-diag + symmetrize), identical to the reference's
  ``coarsen_matrix``/``Pinv`` algebra (``coarsening_utils.py:190-210``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import scipy.sparse as sp


def partition_from_contractions(num_nodes: int,
                                contraction_sets: Sequence[np.ndarray]
                                ) -> np.ndarray:
    """parent[i] = supernode id; uncontracted nodes become singletons.
    Supernode ids are ordered by each group's minimum member (matching the
    reference's min-index-representative remap, ``coarsening_utils.py:168-179``).
    """
    rep = np.arange(num_nodes, dtype=np.int64)
    for nodes in contraction_sets:
        rep[np.asarray(nodes)] = int(np.min(nodes))
    uniq, parent = np.unique(rep, return_inverse=True)
    return parent.astype(np.int64)


def coarsening_matrix(parent: np.ndarray) -> sp.csr_matrix:
    """C (n×N) with C[parent[i], i] = 1/√|S_parent[i]|."""
    n = int(parent.max()) + 1 if parent.size else 0
    counts = np.bincount(parent, minlength=n).astype(np.float64)
    vals = 1.0 / np.sqrt(counts[parent])
    N = parent.shape[0]
    return sp.csr_matrix((vals, (parent, np.arange(N))), shape=(n, N))


def membership_matrix(parent: np.ndarray) -> sp.csr_matrix:
    """Binary N×n membership."""
    n = int(parent.max()) + 1 if parent.size else 0
    N = parent.shape[0]
    return sp.csr_matrix((np.ones(N), (np.arange(N), parent)), shape=(N, n))


def coarsen_weights(W: sp.spmatrix, parent: np.ndarray) -> sp.csr_matrix:
    """Wc = zero_diag(Mᵀ W M), symmetrized."""
    M = membership_matrix(parent)
    Wc = (M.T @ W @ M).tocsr()
    Wc = Wc - sp.diags(Wc.diagonal())
    Wc = (Wc + Wc.T) * 0.5
    Wc.eliminate_zeros()
    return sp.csr_matrix(Wc)


def coarsen_features(X: np.ndarray, parent: np.ndarray) -> np.ndarray:
    """Xc = C·X (1/√|S| scaling — reference semantics, not a plain mean)."""
    return np.asarray(coarsening_matrix(parent) @ X)


def lift_vector(xc: np.ndarray, parent: np.ndarray) -> np.ndarray:
    """x[i] = √|S_parent[i]| · (C⁺ pseudo-lift) = membership copy of xc rows
    (reference ``lift_vector``: Pinv = (C·D)ᵀ with D = 1/colsum → binary)."""
    return np.asarray(xc)[parent]


def compose_partitions(parents: List[np.ndarray]) -> np.ndarray:
    """Compose per-level parent maps into a final node→metanode map."""
    out = parents[0]
    for p in parents[1:]:
        out = p[out]
    return out


def coarse_labels_and_masks(parent: np.ndarray, labels: np.ndarray,
                            mask: np.ndarray, num_classes: int):
    """Coarse labels by masked one-hot vote (reference ``utils.py:713-736``):
    label = argmax over member one-hots restricted to ``mask``; coarse mask is
    True iff ≥1 member in ``mask`` AND all masked members share one class
    (mixed-label supernodes are dropped).
    """
    n = int(parent.max()) + 1 if parent.size else 0
    votes = np.zeros((n, num_classes), dtype=np.float64)
    sel = np.asarray(mask, dtype=bool)
    np.add.at(votes, parent[sel], np.eye(num_classes)[labels[sel]])
    coarse_label = votes.argmax(axis=1).astype(np.int64)
    num_distinct = (votes > 0).sum(axis=1)
    coarse_mask = (votes.sum(axis=1) > 0) & (num_distinct <= 1)
    return coarse_label, coarse_mask
