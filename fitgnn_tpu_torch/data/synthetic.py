"""Synthetic datasets for tests and the on-card smoke run: the port's copy
of the JAX package's generators, drawing the same numpy values in the same
order, so one seed gives the same graphs bit for bit.

* ``ring_graph``           — N nodes on a ring plus 3N random chords, 100
  features, 10 classes (the reference's synthetic dataset).
* ``sbm_graph``            — a homophilous stochastic block model with
  class-mean features, for node classification.
* ``planted_products_graph`` — the products-scale proxy: a planted
  partition whose labels need neighbourhood aggregation (degree 25,
  47 classes; 2,449,029 nodes give ~30.6 M directed edges).
* ``random_regression_graph`` — the same graph with a smooth scalar
  target, for node regression.
* ``qm9_like_dataset``     — a QM9-shaped molecule proxy (9–29 atoms, 11
  features) with a regression target and a 2-class structural label.
* ``random_graph_dataset`` — a small 2-class set: sparse rings against
  denser graphs.
"""

from __future__ import annotations

import numpy as np


def ring_graph(num_nodes: int, num_features: int = 100,
               num_classes: int = 10, seed: int = 0):
    """Ring + random chords; ~4N directed edges before symmetrizing.
    Returns (x, senders, receivers, y)."""
    rng = np.random.default_rng(seed)
    ring_s = np.arange(num_nodes, dtype=np.int64)
    ring_r = (ring_s + 1) % num_nodes
    extra = rng.integers(0, num_nodes, size=(2, 3 * num_nodes))
    senders = np.concatenate([ring_s, extra[0]])
    receivers = np.concatenate([ring_r, extra[1]])
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    x = rng.normal(size=(num_nodes, num_features)).astype(np.float32)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    return x, senders.astype(np.int32), receivers.astype(np.int32), y


def sbm_graph(num_nodes: int = 600, num_classes: int = 4,
              num_features: int = 64, p_in: float = 0.04,
              p_out: float = 0.002, feature_noise: float = 1.0,
              seed: int = 0):
    """Homophilous SBM with class-mean features plus noise; returns (x,
    senders, receivers, y).  Up to 4,000 nodes every pair is drawn, above
    that edges are sampled per pair class."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, num_classes, size=num_nodes).astype(np.int32)
    means = rng.normal(scale=2.0, size=(num_classes, num_features))
    x = (means[y] + feature_noise * rng.normal(size=(num_nodes, num_features))
         ).astype(np.float32)
    if num_nodes <= 4000:
        probs = np.where(y[:, None] == y[None, :], p_in, p_out)
        upper = np.triu(rng.random((num_nodes, num_nodes)) < probs, k=1)
        senders, receivers = np.nonzero(upper)
    else:
        n_in = int(p_in * num_nodes * num_nodes / (2 * num_classes))
        n_out = int(p_out * num_nodes * num_nodes / 2)
        s_in = rng.integers(0, num_nodes, size=4 * n_in)
        r_in = rng.integers(0, num_nodes, size=4 * n_in)
        keep = (y[s_in] == y[r_in]) & (s_in != r_in)
        s1, r1 = s_in[keep][:n_in], r_in[keep][:n_in]
        s_out = rng.integers(0, num_nodes, size=2 * n_out)
        r_out = rng.integers(0, num_nodes, size=2 * n_out)
        keep = y[s_out] != y[r_out]
        s2, r2 = s_out[keep][:n_out], r_out[keep][:n_out]
        senders = np.concatenate([s1, s2])
        receivers = np.concatenate([r1, r2])
    return (x, senders.astype(np.int32), receivers.astype(np.int32), y)


def planted_products_graph(num_nodes: int, degree: int = 25,
                           community_size: int = 512, num_classes: int = 47,
                           num_features: int = 100, intra_p: float = 0.85,
                           feature_sigma: float = 6.0,
                           label_noise: float = 0.1, seed: int = 0):
    """A planted-partition graph whose labels cannot be read off the
    features alone (the regime of ogbn-products, ~0.75-0.85 accuracy).

    * communities of ``community_size`` contiguous nodes; ``intra_p`` of the
      edges stay inside the receiver's community;
    * each community draws a class; a node's label is its community's,
      then a ``label_noise`` fraction is redrawn uniformly;
    * features are the class centroid plus ``feature_sigma``·N(0, I), so
      only aggregation over the mostly same-class neighbours recovers the
      label.

    Returns (x, senders, receivers, y), ~``num_nodes``·``degree``/2
    directed int64 edges (symmetrized downstream)."""
    rng = np.random.default_rng(seed)
    n, e = num_nodes, num_nodes * degree // 2
    rcv = rng.integers(0, n, e, dtype=np.int64)
    comm = rcv // community_size
    snd = np.where(
        rng.random(e) < intra_p,
        np.minimum(comm * community_size
                   + rng.integers(0, community_size, e), n - 1),
        rng.integers(0, n, e, dtype=np.int64))
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    n_comm = (n + community_size - 1) // community_size
    class_of_comm = rng.integers(0, num_classes, n_comm)
    y_true = class_of_comm[np.arange(n) // community_size].astype(np.int64)
    centroids = rng.standard_normal(
        (num_classes, num_features)).astype(np.float32)
    x = (centroids[y_true]
         + feature_sigma * rng.standard_normal(
             (n, num_features)).astype(np.float32))
    y = y_true.copy()
    if label_noise > 0:
        flip = rng.random(n) < label_noise
        y[flip] = rng.integers(0, num_classes, int(flip.sum()))
    return x, snd, rcv, y


def random_regression_graph(num_nodes: int = 400, num_features: int = 32,
                            seed: int = 0):
    """``sbm_graph`` (3 classes) with a smooth scalar target: a linear
    function of x, averaged half and half with its neighbours' mean."""
    rng = np.random.default_rng(seed)
    x, senders, receivers, _ = sbm_graph(
        num_nodes=num_nodes, num_classes=3, num_features=num_features,
        seed=seed)
    w = rng.normal(size=num_features) / np.sqrt(num_features)
    y = (x @ w).astype(np.float32)
    deg = np.zeros(num_nodes)
    np.add.at(deg, receivers, 1.0)
    np.add.at(deg, senders, 1.0)
    agg = np.zeros(num_nodes, dtype=np.float32)
    np.add.at(agg, receivers, y[senders])
    np.add.at(agg, senders, y[receivers])
    y = 0.5 * y + 0.5 * agg / np.maximum(deg, 1.0).astype(np.float32)
    return x, senders, receivers, y


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
