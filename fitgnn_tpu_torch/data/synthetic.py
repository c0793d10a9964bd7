"""Synthetic graph-level datasets for tests and the on-card smoke run: the
port's copy of the JAX package's generators, drawing the same numpy values
in the same order, so one seed gives the same graphs bit for bit.

* ``qm9_like_dataset``     — a QM9-shaped molecule proxy (9–29 atoms, 11
  features) with a regression target and a 2-class structural label.
* ``random_graph_dataset`` — a small 2-class set: sparse rings against
  denser graphs.
"""

from __future__ import annotations

import numpy as np


def qm9_like_dataset(num_graphs: int = 130_831, min_nodes: int = 9,
                     max_nodes: int = 29, num_features: int = 11,
                     seed: int = 0):
    """QM9-scale molecule proxy (130,831 graphs, ~18 heavy atoms each):
    ring backbone plus density-varying chords, with a scalar regression
    target (edge density + feature mean + noise) and a 2-class label
    (sparse against dense).  Returns (graphs, y_reg, y_cls), graphs a list
    of (x, senders, receivers)."""
    rng = np.random.default_rng(seed)
    ns = rng.integers(min_nodes, max_nodes + 1, num_graphs)
    dens = rng.random(num_graphs)                 # 0 = sparse, 1 = dense
    y_cls = (dens > 0.5).astype(np.int32)
    graphs = []
    y_reg = np.empty(num_graphs, dtype=np.float32)
    noise = 0.05 * rng.standard_normal(num_graphs).astype(np.float32)
    for i in range(num_graphs):
        n = int(ns[i])
        extra = int(n * (0.5 + 3.0 * dens[i]))
        es = rng.integers(0, n, extra)
        er = rng.integers(0, n, extra)
        keep = es != er
        s = np.concatenate([np.arange(n), es[keep]]).astype(np.int32)
        r = np.concatenate([(np.arange(n) + 1) % n, er[keep]]).astype(
            np.int32)
        x = rng.normal(size=(n, num_features)).astype(np.float32)
        graphs.append((x, s, r))
        y_reg[i] = (len(s) / n) + 0.5 * float(x.mean()) + noise[i]
    return graphs, y_reg, y_cls


def random_graph_dataset(num_graphs: int = 60, min_nodes: int = 10,
                         max_nodes: int = 30, num_features: int = 8,
                         num_classes: int = 2, seed: int = 0):
    """Small graph-classification set: class 0 = sparse rings, class 1 =
    denser graphs; returns a list of (x, senders, receivers) and the
    labels."""
    rng = np.random.default_rng(seed)
    graphs, labels = [], []
    for _ in range(num_graphs):
        n = int(rng.integers(min_nodes, max_nodes + 1))
        label = int(rng.integers(0, num_classes))
        ring_s = np.arange(n)
        ring_r = (ring_s + 1) % n
        extra_count = n * (1 + 3 * label)  # denser for higher class
        es = rng.integers(0, n, size=extra_count)
        er = rng.integers(0, n, size=extra_count)
        keep = es != er
        senders = np.concatenate([ring_s, es[keep]]).astype(np.int32)
        receivers = np.concatenate([ring_r, er[keep]]).astype(np.int32)
        x = rng.normal(loc=label, size=(n, num_features)).astype(np.float32)
        graphs.append((x, senders, receivers))
        labels.append(label)
    return graphs, np.asarray(labels, dtype=np.int32)
