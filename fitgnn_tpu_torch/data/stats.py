"""Dataset statistics (the reference's ``dataset_info.csv``): nodes, edges,
features, classes or the label spread, and the three homophily measures
(PyG's definitions), computed in numpy as the JAX package's
``data/stats.py`` computes them."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def edge_homophily(senders, receivers, y) -> float:
    """Fraction of edges connecting same-label endpoints."""
    if len(senders) == 0:
        return 0.0
    return float(np.mean(y[senders] == y[receivers]))


def node_homophily(senders, receivers, y, num_nodes: int) -> float:
    """Mean over nodes of the same-label fraction among their neighbors."""
    same = (y[senders] == y[receivers]).astype(np.float64)
    num = np.zeros(num_nodes)
    den = np.zeros(num_nodes)
    np.add.at(num, receivers, same)
    np.add.at(den, receivers, 1.0)
    has = den > 0
    return float((num[has] / den[has]).mean()) if has.any() else 0.0


def edge_insensitive_homophily(senders, receivers, y, num_nodes: int) -> float:
    """Class-insensitive edge homophily (Lim et al.): the sum over classes
    of max(h_k − |C_k|/n, 0), over K − 1, with h_k the same-label fraction
    among the edges into class k."""
    classes = np.unique(y)
    k = len(classes)
    if k <= 1 or len(senders) == 0:
        return 0.0
    total = 0.0
    for c in classes:
        sel = y[receivers] == c
        hk = float(np.mean(y[senders[sel]] == c)) if sel.sum() else 0.0
        total += max(hk - float((y == c).sum()) / num_nodes, 0.0)
    return total / (k - 1)


@dataclasses.dataclass
class DatasetStats:
    name: str
    num_nodes: int
    num_edges: int
    num_features: int
    num_classes: Optional[int] = None
    label_std: Optional[float] = None
    homophily_edge: Optional[float] = None
    homophily_node: Optional[float] = None
    homophily_edge_insensitive: Optional[float] = None

    def csv_row(self) -> str:
        def fmt(v):
            return "" if v is None else (f"{v:.4f}" if isinstance(v, float)
                                         else str(v))
        return ",".join(fmt(v) for v in (
            self.name, self.num_nodes, self.num_edges, self.num_features,
            self.num_classes, self.label_std, self.homophily_edge,
            self.homophily_node, self.homophily_edge_insensitive))

    CSV_HEADER = ("dataset,num_nodes,num_edges,num_features,num_classes,"
                  "label_std,homophily_edge,homophily_node,"
                  "homophily_edge_insensitive")


def node_dataset_stats(name: str, x, senders, receivers, y,
                       classification: bool = True) -> DatasetStats:
    n = x.shape[0]
    # the undirected unique edge count, self loops left out (the reference
    # reports |E| undirected)
    key = np.minimum(senders, receivers) * n + np.maximum(senders, receivers)
    num_edges = len(np.unique(key[senders != receivers]))
    stats = DatasetStats(name=name, num_nodes=n, num_edges=num_edges,
                         num_features=x.shape[1])
    if classification:
        stats.num_classes = int(len(np.unique(y)))
        stats.homophily_edge = edge_homophily(senders, receivers, y)
        stats.homophily_node = node_homophily(senders, receivers, y, n)
        stats.homophily_edge_insensitive = edge_insensitive_homophily(
            senders, receivers, y, n)
    else:
        stats.label_std = float(np.std(y))
    return stats
