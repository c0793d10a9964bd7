"""Split generators.

* node classification: ``random`` (20 train / 30 val per class), ``few``
  (5/5 per class), ``ogbn_split`` (8 % / 2 % / 90 %); ``fixed`` keeps the
  dataset's masks and is handled by the caller
* node regression: ratio-based random split
* graph-level tasks: 1/2 train, 1/4 val, 1/4 test over shuffled graphs
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def splits_classification(y: np.ndarray, num_classes: int, experiment: str,
                          seed: int = 0
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Return (train_mask, val_mask, test_mask)."""
    rng = np.random.default_rng(seed)
    n = y.shape[0]
    train = np.zeros(n, dtype=bool)
    val = np.zeros(n, dtype=bool)
    test = np.zeros(n, dtype=bool)
    if experiment == "ogbn_split":
        perm = rng.permutation(n)
        n_tr, n_va = int(0.08 * n), int(0.02 * n)
        train[perm[:n_tr]] = True
        val[perm[n_tr:n_tr + n_va]] = True
        test[perm[n_tr + n_va:]] = True
        return train, val, test
    if experiment in ("random", "few"):
        k_tr, k_va = (20, 30) if experiment == "random" else (5, 5)
        for c in range(num_classes):
            idx = np.where(y == c)[0]
            idx = rng.permutation(idx)
            train[idx[:k_tr]] = True
            val[idx[k_tr:k_tr + k_va]] = True
            test[idx[k_tr + k_va:]] = True
        return train, val, test
    raise ValueError(f"unknown experiment {experiment!r} "
                     "(fixed splits come from the dataset)")


def splits_regression(num_nodes: int, train_ratio: float, val_ratio: float,
                      seed: int = 0):
    if train_ratio + val_ratio >= 1:
        raise ValueError("train_ratio + val_ratio must be < 1")
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_nodes)
    n_tr = int(train_ratio * num_nodes)
    n_va = int(val_ratio * num_nodes)
    train = np.zeros(num_nodes, dtype=bool)
    val = np.zeros(num_nodes, dtype=bool)
    test = np.zeros(num_nodes, dtype=bool)
    train[perm[:n_tr]] = True
    val[perm[n_tr:n_tr + n_va]] = True
    test[perm[n_tr + n_va:]] = True
    return train, val, test


def splits_graph_level(num_graphs: int, seed: int = 0):
    """(train, val, test) graph indices: 1/2, 1/4 and the rest of a
    permutation, as the JAX package's ``splits_graph_level``."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(num_graphs)
    n_tr = num_graphs // 2
    n_va = num_graphs // 4
    return perm[:n_tr], perm[n_tr:n_tr + n_va], perm[n_tr + n_va:]
