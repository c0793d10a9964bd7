"""Production ingest optimization: community reorder + hybrid operator.

Two-level C++ Leiden ordering makes the adjacency block-dense, then the
hybrid BCSR + straggler operator (K1 + K3, or GAT's attention tiles)
replaces the per-edge SpMM.

Node reorder is exact: a permutation of nodes permutes the rows of every
per-node tensor and both endpoints of every edge, so outputs are the same
up to that permutation (masks and labels permute with the nodes).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.container import Graph

# below this many nodes the plain COO path serves the graph
AUTO_MIN_NODES = 65_536


_LAYER_SEMANTICS = {"GCNConv": "gcn_norm", "SAGEConv": "mean_nonself",
                    "GINConv": "sum_nonself", "GATConv": "att_unit"}


def _operator_weights(senders, receivers, gcn_weight, num_nodes,
                      semantics: str) -> np.ndarray:
    """Edge weights encoding a layer's aggregation as a static SpMM.
    Padding edges (weight-0 self-loops on the pad node) stay 0."""
    s = np.asarray(senders, dtype=np.int64)
    r = np.asarray(receivers, dtype=np.int64)
    if semantics == "gcn_norm":
        return np.asarray(gcn_weight)
    if semantics == "att_unit":             # GAT: presence incl self-loops
        return (np.asarray(gcn_weight) > 0).astype(np.float32)
    nonself = (s != r).astype(np.float32)
    if semantics == "sum_nonself":          # GIN Σ_neigh
        return nonself
    if semantics == "mean_nonself":         # SAGE mean_neigh (0 if none)
        indeg = np.bincount(r[nonself > 0], minlength=num_nodes)
        return (nonself / np.maximum(indeg[r], 1.0)).astype(np.float32)
    raise ValueError(f"unknown operator semantics {semantics!r}")


def build_optimized_graph(x: np.ndarray, senders: np.ndarray,
                          receivers: np.ndarray, *, y=None, train_mask=None,
                          val_mask=None, test_mask=None,
                          min_block_edges: int = 48,
                          tile_dtype=None, use_segmm: bool = True,
                          tile_group: int = 1, layer_name: str = "GCNConv",
                          use_diag: bool = False,
                          cluster_att: int = 0,
                          cluster_att_exact: int = 0,
                          cluster_agg: int = 0,
                          cluster_agg_exact: int = 0,
                          seed: int = 0) -> tuple[Graph, np.ndarray]:
    """Reorder nodes by two-level Leiden communities, build the padded
    ``Graph`` (CPU tensors) and attach a ``HybridSpmm`` operator as
    ``g.aux``.

    Returns ``(graph, order)`` where ``order[i]`` is the original id of the
    node now at position ``i``.  Defaults are the JAX package's production
    config (threshold 48, f32 tiles, K3 stragglers); ``tile_group`` and
    ``use_diag`` pass through to ``build_hybrid`` (K9, K8), which refuses
    them for GATConv.  The planner's ``min_block_edges="auto"``, bf16 tiles
    and the cluster opt-ins are not ported yet."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.partition.community import \
        hierarchical_community_order

    if min_block_edges == "auto":
        raise NotImplementedError("min_block_edges='auto' needs the ingest "
                                  "planner (ROADMAP.md §1 item 2)")
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    n = x.shape[0]
    order = hierarchical_community_order(senders, receivers, n, seed=seed)
    inv = np.empty(n, dtype=np.int64)
    inv[order] = np.arange(n)

    def perm(a):
        return None if a is None else np.asarray(a)[order]

    g = build_graph(np.asarray(x)[order], inv[senders].astype(np.int32),
                    inv[receivers].astype(np.int32), y=perm(y),
                    train_mask=perm(train_mask), val_mask=perm(val_mask),
                    test_mask=perm(test_mask), node_pad_to=128)
    semantics = _LAYER_SEMANTICS[layer_name]
    s_np = g.senders.numpy().astype(np.int64)
    r_np = g.receivers.numpy().astype(np.int64)
    w_op = _operator_weights(s_np, r_np, g.edge_weight.numpy(),
                             g.num_nodes_padded, semantics)
    hyb = build_hybrid(s_np, r_np, w_op, g.num_nodes_padded,
                       min_block_edges=min_block_edges,
                       tile_dtype=tile_dtype,
                       use_segmm=use_segmm, use_diag=use_diag,
                       tile_group=tile_group, semantics=semantics,
                       cluster_att=cluster_att,
                       cluster_att_exact=cluster_att_exact,
                       cluster_agg=cluster_agg,
                       cluster_agg_exact=cluster_agg_exact)
    return g._replace(aux=hyb), order


def optimize_coarse(coarse, *, min_block_edges: int = 48,
                    layer_name: str = "GCNConv", seed: int = 0):
    """Leiden-reorder a ``CoarseData``'s graph (CPU tensors) and attach the
    hybrid operator, as the JAX package's ``optimize_coarse`` does: a large
    Gc is a full-graph training problem and takes the same path as
    ``--baseline``.

    Only Gc's own node order changes (with its label and mask views); the
    Gs phase takes the transferred parameters, not Gc node ids.  The node
    arrays grow to a multiple of 128 with inert rows (zero features, False
    masks).  The JAX package's bf16 tiles, tile groups and cluster
    collapses are not ported yet (ROADMAP.md §1 item 2)."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.partition.community import \
        hierarchical_community_order

    if min_block_edges == "auto":
        raise NotImplementedError("min_block_edges='auto' needs the ingest "
                                  "planner (ROADMAP.md §1 item 2)")
    g = coarse.graph
    n_real = int(g.n_node)
    n_pad = g.num_nodes_padded
    s = g.senders.numpy().astype(np.int64)
    r = g.receivers.numpy().astype(np.int64)
    w = g.edge_weight.numpy()
    e_real = int(g.n_edge)
    order = hierarchical_community_order(s[:e_real], r[:e_real], n_real,
                                         seed=seed)
    perm = np.concatenate([order, np.arange(n_real, n_pad)])  # pads stay
    inv = np.empty(n_pad, dtype=np.int64)
    inv[perm] = np.arange(n_pad)
    s2, r2 = inv[s], inv[r]
    # receivers sorted ascending (the padding tail's weight-0 self loops on
    # the pad node sort to the end)
    esort = np.argsort(r2, kind="stable")
    s2, r2, w2 = s2[esort], r2[esort], w[esort]
    extra = (-n_pad) % 128
    n_pad += extra

    def pnode(a):
        if a is None:
            return None
        a = a.numpy()[perm]
        if extra:
            a = np.pad(a, [(0, extra)] + [(0, 0)] * (a.ndim - 1))
        return torch.from_numpy(a)

    semantics = _LAYER_SEMANTICS[layer_name]
    w_op = _operator_weights(s2, r2, w2, n_pad, semantics)
    hyb = build_hybrid(s2, r2, w_op, n_pad, min_block_edges=min_block_edges,
                       use_segmm=True, semantics=semantics)
    g2 = g._replace(x=pnode(g.x),
                    senders=torch.from_numpy(s2.astype(np.int32)),
                    receivers=torch.from_numpy(r2.astype(np.int32)),
                    edge_weight=torch.from_numpy(w2), y=pnode(g.y),
                    train_mask=pnode(g.train_mask),
                    val_mask=pnode(g.val_mask),
                    test_mask=pnode(g.test_mask), aux=hyb)
    return dataclasses.replace(
        coarse, graph=g2, y_train=pnode(coarse.y_train),
        train_mask=pnode(coarse.train_mask), y_val=pnode(coarse.y_val),
        val_mask=pnode(coarse.val_mask))


def should_use_hybrid(num_nodes: int, layer_name: str,
                      mode: str = "auto") -> bool:
    """Gate for the CLI (``--hybrid_spmm``): static-weight aggregations and
    GAT's tiles take the hybrid operator from ``AUTO_MIN_NODES`` nodes up
    under ``auto``, always under ``on``, never under ``off``."""
    if mode == "off":
        return False
    if mode == "on":
        return layer_name in _LAYER_SEMANTICS
    return layer_name in _LAYER_SEMANTICS and num_nodes >= AUTO_MIN_NODES
