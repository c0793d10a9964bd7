"""Host-side (numpy) graph construction and padding.

Runs once at ingest.  The normalization mirrors PyG's ``GCNConv``
preprocessing (add self loops + symmetric D^-1/2 A D^-1/2), so downstream
layers only do weighted aggregation.  The arrays are built in numpy exactly
as the JAX package builds them and become CPU tensors at the end; callers
move the graph with ``Graph.to(device)``.

The JAX package sends unweighted inputs of more than 2 M edges through a
one-pass C++ core (``fitgnn_tpu/graph/native_build.py``); that branch is
not ported yet, so every input takes the numpy branch here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.graph.container import Graph


def to_undirected(senders: np.ndarray, receivers: np.ndarray,
                  weight: Optional[np.ndarray] = None):
    """Symmetrize + dedupe an edge list (numpy)."""
    if weight is None:
        weight = np.ones(senders.shape[0], dtype=np.float32)
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    w = np.concatenate([weight, weight])
    key = s.astype(np.int64) * (max(int(r.max(initial=0)),
                                    int(s.max(initial=0))) + 1) + r
    _, idx = np.unique(key, return_index=True)
    return s[idx], r[idx], w[idx]


def add_self_loops(senders: np.ndarray, receivers: np.ndarray,
                   weight: np.ndarray, num_nodes: int, fill: float = 1.0):
    """Append one self loop per node (numpy). Existing self loops are kept."""
    loop = np.arange(num_nodes, dtype=senders.dtype)
    s = np.concatenate([senders, loop])
    r = np.concatenate([receivers, loop])
    w = np.concatenate([weight, np.full(num_nodes, fill, dtype=weight.dtype)])
    return s, r, w


def gcn_normalize(senders: np.ndarray, receivers: np.ndarray,
                  weight: np.ndarray, num_nodes: int) -> np.ndarray:
    """Symmetric normalization ``w_e / sqrt(deg[s] * deg[r])`` (numpy)."""
    deg = np.zeros(num_nodes, dtype=np.float64)
    np.add.at(deg, receivers, weight.astype(np.float64))
    dinv = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    return (weight * dinv[senders] * dinv[receivers]).astype(np.float32)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sort_by_receiver(senders, receivers, weight):
    order = np.argsort(receivers, kind="stable")
    return senders[order], receivers[order], weight[order]


def build_graph(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    *,
    edge_weight: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    undirected: bool = True,
    self_loops: bool = True,
    normalize: bool = True,
    node_pad_to: int = 8,
    edge_pad_to: int = 128,
    dtype=np.float32,
) -> Graph:
    """Build a padded ``Graph`` of CPU tensors from numpy arrays.

    Padding reserves at least one extra node (the sink of padding edges).
    """
    num_nodes = int(x.shape[0])
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    if edge_weight is None:
        edge_weight = np.ones(senders.shape[0], dtype=np.float32)
    edge_weight = np.asarray(edge_weight, dtype=np.float32)

    if undirected and senders.size:
        senders, receivers, edge_weight = to_undirected(
            senders, receivers, edge_weight)
    if self_loops:
        senders, receivers, edge_weight = add_self_loops(
            senders, receivers, edge_weight, num_nodes)
    if normalize:
        edge_weight = gcn_normalize(senders, receivers, edge_weight,
                                    num_nodes)
    senders, receivers, edge_weight = sort_by_receiver(
        senders, receivers, edge_weight)

    num_edges = int(senders.shape[0])
    n_pad = max(_round_up(num_nodes + 1, node_pad_to), node_pad_to)
    e_pad = max(_round_up(max(num_edges, 1), edge_pad_to), edge_pad_to)

    def pad_nodes(a, fill=0):
        if a is None:
            return None
        pad_shape = (n_pad - num_nodes,) + a.shape[1:]
        return np.concatenate(
            [a, np.full(pad_shape, fill, dtype=a.dtype)], axis=0)

    xs = pad_nodes(np.asarray(x, dtype=dtype))
    s = np.full(e_pad, n_pad - 1, dtype=np.int32)
    r = np.full(e_pad, n_pad - 1, dtype=np.int32)
    w = np.zeros(e_pad, dtype=np.float32)
    s[:num_edges], r[:num_edges], w[:num_edges] = senders, receivers, \
        edge_weight

    def as_tensor(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a))

    def mask(m):
        return None if m is None else as_tensor(
            pad_nodes(np.asarray(m, dtype=bool), fill=False))

    return Graph(
        x=as_tensor(xs),
        senders=as_tensor(s),
        receivers=as_tensor(r),
        edge_weight=as_tensor(w),
        n_node=torch.tensor(num_nodes, dtype=torch.int32),
        n_edge=torch.tensor(num_edges, dtype=torch.int32),
        y=as_tensor(pad_nodes(None if y is None else np.asarray(y))),
        train_mask=mask(train_mask),
        val_mask=mask(val_mask),
        test_mask=mask(test_mask),
    )
