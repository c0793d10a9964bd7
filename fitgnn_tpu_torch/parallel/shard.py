"""Host-side graph sharding for graph data parallelism, as the JAX
package's ``parallel/shard.py`` builds it (numpy throughout).

Nodes are partitioned into contiguous per-shard blocks (callers pre-order
them by community, ``multihost.placement_by_community``), and each shard
owns the edges whose *receiver* is local.  Sender indices stay global.
The arrays keep the shard axis in front; ``ShardedGraph.local(p, device)``
moves shard ``p``'s slice to the device that rank ``p`` runs on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from fitgnn_tpu_torch.graph.build import _round_up, gcn_normalize
from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                             _operator_weights)

#: aggregation-weight semantics per conv layer: the sharded layers'
#: aggregation (GCN's symmetric normalization, SAGE's neighbour mean,
#: GIN's neighbour sum, GAT's unit mask) is baked into the edge weights
LAYER_SEMANTICS = dict(_LAYER_SEMANTICS)


class LocalShard(NamedTuple):
    """One shard's node arrays on its rank's device."""

    x: torch.Tensor             # (N_loc, F)
    y: torch.Tensor             # (N_loc, ...)
    train_mask: torch.Tensor    # (N_loc,) bool
    val_mask: torch.Tensor
    test_mask: torch.Tensor


class LocalEdges(NamedTuple):
    """One shard's edges on its rank's device: global senders (the
    all-gather table's row ids), local receivers."""

    senders: torch.Tensor       # (E_loc,) int64
    receivers: torch.Tensor     # (E_loc,) int64
    edge_weight: torch.Tensor   # (E_loc,)


class ShardedGraph(NamedTuple):
    """Leading axis = shard. Senders are GLOBAL ids; receivers LOCAL."""

    x: np.ndarray               # (P, N_loc, F)
    senders: np.ndarray         # (P, E_loc) global node ids
    receivers: np.ndarray       # (P, E_loc) local row ids
    edge_weight: np.ndarray     # (P, E_loc)
    y: np.ndarray               # (P, N_loc, ...)
    train_mask: np.ndarray      # (P, N_loc)
    val_mask: np.ndarray
    test_mask: np.ndarray

    @property
    def num_shards(self) -> int:
        return self.x.shape[0]

    @property
    def nodes_per_shard(self) -> int:
        return self.x.shape[1]

    @property
    def num_nodes_global(self) -> int:
        return self.x.shape[0] * self.x.shape[1]

    def local(self, p: int, device) -> LocalShard:
        """Shard ``p``'s node arrays on ``device``: labels as int64 when
        they are integers (classification), else float32 (regression)."""
        y = self.y[p]
        y = y.astype(np.int64 if np.issubdtype(y.dtype, np.integer)
                     else np.float32)
        return LocalShard(*(torch.from_numpy(np.ascontiguousarray(a)).to(
            device) for a in (self.x[p], y, self.train_mask[p],
                              self.val_mask[p], self.test_mask[p])))

    def local_edges(self, p: int, device) -> LocalEdges:
        """Shard ``p``'s edges on ``device``, indices as int64."""
        return LocalEdges(*(torch.from_numpy(np.ascontiguousarray(a)).to(
            device) for a in (self.senders[p].astype(np.int64),
                              self.receivers[p].astype(np.int64),
                              self.edge_weight[p])))


def shard_graph(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    y: np.ndarray,
    num_shards: int,
    *,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    order: Optional[np.ndarray] = None,
    self_loops: bool = True,
    normalize: bool = True,
    edge_pad_to: int = 128,
    semantics: Optional[str] = None,
) -> ShardedGraph:
    """Partition a node-labelled graph into ``num_shards`` contiguous blocks.

    ``order``: optional node permutation applied first (community placement).
    Edge weights are computed on the *global* graph before sharding, so
    sharded aggregation equals single-device aggregation.
    ``semantics``: one of ``LAYER_SEMANTICS.values()`` — overrides
    ``self_loops``/``normalize`` with the layer's aggregation weights
    (default: ``"gcn_norm"``'s).
    """
    if semantics is not None:
        if semantics == "gcn_norm":
            self_loops, normalize = True, True
        elif semantics in ("mean_nonself", "sum_nonself"):
            self_loops, normalize = False, False
        elif semantics == "att_unit":
            self_loops, normalize = True, False
        else:
            raise ValueError(f"unknown shard semantics {semantics!r}")
    n = x.shape[0]
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if order is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        x = x[order]
        y = np.asarray(y)[order]
        senders, receivers = inv[senders], inv[receivers]
        train_mask = None if train_mask is None else np.asarray(train_mask)[order]
        val_mask = None if val_mask is None else np.asarray(val_mask)[order]
        test_mask = None if test_mask is None else np.asarray(test_mask)[order]

    # symmetrize
    s = np.concatenate([senders, receivers])
    r = np.concatenate([receivers, senders])
    keep = s != r
    s, r = s[keep], r[keep]
    key = s * n + r
    _, idx = np.unique(key, return_index=True)
    s, r = s[idx], r[idx]
    w = np.ones(len(s), dtype=np.float32)
    if self_loops:
        loop = np.arange(n, dtype=np.int64)
        s = np.concatenate([s, loop])
        r = np.concatenate([r, loop])
        w = np.concatenate([w, np.ones(n, dtype=np.float32)])
    if normalize:
        w = gcn_normalize(s, r, w, n)
    if semantics == "mean_nonself":
        # neighbour mean = segment sum with 1/indeg weights (non-self edges
        # only; isolated nodes aggregate to 0)
        w = _operator_weights(s, r, w, n, "mean_nonself")

    return _partition_blocks(x, s, r, w, y, num_shards, train_mask, val_mask,
                             test_mask, edge_pad_to)


def shard_prebuilt_graph(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    weight: np.ndarray,
    y: np.ndarray,
    num_shards: int,
    *,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    order: Optional[np.ndarray] = None,
    edge_pad_to: int = 128,
) -> ShardedGraph:
    """Shard an ALREADY-PROCESSED edge list verbatim (no symmetrization, no
    self-loop insertion, no renormalization), for graphs whose aggregation
    weights were built elsewhere (the coarse Gc graph, whose GCN weights
    normalize the weighted coarse adjacency).  Zero-weight (padding) edges
    are dropped."""
    n = x.shape[0]
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float32)
    keep = weight != 0
    s, r, w = senders[keep], receivers[keep], weight[keep]
    y = np.asarray(y)
    if order is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        x, y = x[order], y[order]
        s, r = inv[s], inv[r]
        train_mask = (None if train_mask is None
                      else np.asarray(train_mask)[order])
        val_mask = None if val_mask is None else np.asarray(val_mask)[order]
        test_mask = (None if test_mask is None
                     else np.asarray(test_mask)[order])
    return _partition_blocks(x, s, r, w, y, num_shards, train_mask, val_mask,
                             test_mask, edge_pad_to)


def shard_node_array(a: np.ndarray, num_shards: int, nodes_per_shard: int,
                     *, order: Optional[np.ndarray] = None,
                     fill=0) -> np.ndarray:
    """Pad + reshape a per-node array to ``(num_shards, nodes_per_shard, …)``
    — the same node placement ``_partition_blocks`` applies, for arrays that
    travel alongside an existing :class:`ShardedGraph` without re-sharding
    the whole graph."""
    a = np.asarray(a)
    if order is not None:
        a = a[order]
    n_pad = num_shards * nodes_per_shard
    out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
    out[:len(a)] = a
    return out.reshape((num_shards, nodes_per_shard) + a.shape[1:])


def _partition_blocks(x, s, r, w, y, num_shards, train_mask, val_mask,
                      test_mask, edge_pad_to) -> ShardedGraph:
    """Common tail: contiguous node blocks, per-receiver edge placement,
    padding to uniform shapes."""
    n = x.shape[0]
    n_loc = _round_up(-(-n // num_shards), 8)
    n_pad = n_loc * num_shards

    def pad_nodes(a, fill=0):
        a = np.asarray(a)
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
        out[:n] = a
        return out.reshape((num_shards, n_loc) + a.shape[1:])

    shard_of = r // n_loc
    e_per = np.bincount(shard_of, minlength=num_shards)
    e_loc = max(_round_up(max(int(e_per.max()), 1), edge_pad_to), edge_pad_to)

    # padding edges: point at the shard's last local slot with weight 0
    ss = np.zeros((num_shards, e_loc), dtype=np.int32)
    rr = np.full((num_shards, e_loc), n_loc - 1, dtype=np.int32)
    ww = np.zeros((num_shards, e_loc), dtype=np.float32)
    for p in range(num_shards):
        sel = shard_of == p
        cnt = int(sel.sum())
        order_ = np.argsort(r[sel] - p * n_loc, kind="stable")
        ss[p, :cnt] = s[sel][order_]
        rr[p, :cnt] = (r[sel] - p * n_loc)[order_]
        ww[p, :cnt] = w[sel][order_]
        ss[p, cnt:] = p * n_loc  # arbitrary valid global id, weight 0

    zeros = np.zeros(n, dtype=bool)
    return ShardedGraph(
        x=pad_nodes(x.astype(np.float32)),
        senders=ss, receivers=rr, edge_weight=ww,
        y=pad_nodes(y),
        train_mask=pad_nodes(zeros if train_mask is None else train_mask,
                             fill=False),
        val_mask=pad_nodes(zeros if val_mask is None else val_mask,
                           fill=False),
        test_mask=pad_nodes(zeros if test_mask is None else test_mask,
                            fill=False))
