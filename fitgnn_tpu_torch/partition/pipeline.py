"""End-to-end preprocessing pipeline: components → coarsen → Gc + subgraphs.

The array-native analog of the reference's ``coarsening_classification`` /
``coarsening_regression`` + ``load_data_classification`` / ``_regression``
(``utils.py:143-605, 661-809``):

1. split the graph into connected components (largest first),
2. coarsen each component independently; offset metanode ids so the
   node→metanode ``parent`` map is global,
3. assemble the trainable coarse graph **Gc**: components with >10 nodes and
   ≥1 train/val node contribute their coarse projection (Xc = C·X, summed
   coarse edges, masked one-hot label votes with mixed-label dropping);
   smaller components with train/val nodes pass through uncoarsened;
   components with no train/val nodes are excluded (``utils.py:713,754-769``),
4. build the per-metanode subgraph batch in the requested node mode.

The port's copy of the JAX package's ``partition/pipeline.py``: the same
numpy, with CPU tensors in ``CoarseData`` and the ``SubgraphBatch``.
Size-bucketed batches (``bucket=True``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.sparse as sp
import torch

from fitgnn_tpu_torch.coarsen import (
    coarsen, connected_components, coarsen_features,
    coarse_labels_and_masks, coarsening_matrix,
)
from fitgnn_tpu_torch.graph.build import build_graph
from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch
from fitgnn_tpu_torch.partition.subgraphs import extract_subgraphs, pad_subgraphs
from fitgnn_tpu_torch.utils.device import dataclass_to


@dataclasses.dataclass
class CoarseData:
    """The trainable coarse graph with separate train/val label views
    (reference keeps coarse train and val labels as distinct arrays,
    ``utils.py:739-742``)."""

    graph: Graph                      # x + coarse edges (padded, normalized)
    y_train: torch.Tensor             # (N_pad,) argmax-vote labels (cls) or C·y (reg)
    train_mask: torch.Tensor          # (N_pad,) bool
    y_val: torch.Tensor
    val_mask: torch.Tensor

    def to(self, device) -> "CoarseData":
        """The same data, every tensor (and the graph's operator) on
        ``device``."""
        return dataclass_to(self, device)


@dataclasses.dataclass
class PartitionedDataset:
    parent: np.ndarray                # (N,) global node → metanode
    coarse: Optional[CoarseData]      # None when no component qualifies
    subgraphs: SubgraphBatch
    num_metanodes: int


def _component_adjacency(senders: np.ndarray, receivers: np.ndarray,
                         num_nodes: int) -> sp.csr_matrix:
    w = np.ones(len(senders), dtype=np.float64)
    W = sp.csr_matrix((w, (senders, receivers)), shape=(num_nodes, num_nodes))
    W = W + W.T
    W.data[:] = np.minimum(W.data, 1.0)  # simple graph
    W.setdiag(0)
    W.eliminate_zeros()
    return W


def coarsen_and_partition(
    x: np.ndarray,
    senders: np.ndarray,
    receivers: np.ndarray,
    y: np.ndarray,
    *,
    reduction: float = 0.5,
    method: str = "variation_neighborhoods",
    mode: str = "plain",
    task: str = "classification",
    num_classes: Optional[int] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    K: int = 10,
    seed: int = 0,
    min_coarsen_size: int = 10,
    node_pad_to: int = 8,
    edge_pad_to: int = 128,
    bucket: bool = False,
    max_buckets: int = 0,
) -> PartitionedDataset:
    if bucket:
        raise NotImplementedError(
            "coarsen_and_partition(bucket=True): size-bucketed subgraph "
            "batches are not ported yet (ROADMAP.md §1 item 1, bucketing)")
    N = x.shape[0]
    W = _component_adjacency(senders, receivers, N)
    comps = connected_components(W)

    parent = np.full(N, -1, dtype=np.int64)
    offset = 0
    comp_results = []          # (comp_nodes, CoarseningResult | None)
    for comp in comps:
        if len(comp) > 1:
            res = coarsen(W[comp][:, comp], r=reduction, method=method,
                          K=K, seed=seed)
            parent[comp] = res.parent + offset
            offset += res.num_coarse
            comp_results.append((comp, res))
        else:
            parent[comp] = offset
            offset += 1
            comp_results.append((comp, None))
    num_meta = offset

    coarse = _assemble_coarse(
        W, comp_results, x, y, task, num_classes, train_mask, val_mask,
        min_coarsen_size, node_pad_to, edge_pad_to)

    # coarse features per global metanode (for cluster_node summaries)
    coarse_x_global = np.zeros((num_meta, x.shape[1]), dtype=np.float32)
    cw_rows, cw_cols, cw_vals = [], [], []
    for comp, res in comp_results:
        if res is None:
            coarse_x_global[parent[comp[0]]] = x[comp[0]]
            continue
        base = parent[comp].min()
        coarse_x_global[base:base + res.num_coarse] = coarsen_features(
            x[comp], res.parent)
        coo = res.Wc.tocoo()
        cw_rows.append(coo.row + base)
        cw_cols.append(coo.col + base)
        cw_vals.append(coo.data)
    if cw_rows:
        coarse_W_global = sp.csr_matrix(
            (np.concatenate(cw_vals),
             (np.concatenate(cw_rows), np.concatenate(cw_cols))),
            shape=(num_meta, num_meta))
    else:
        coarse_W_global = sp.csr_matrix((num_meta, num_meta))

    specs = extract_subgraphs(W, x, parent, mode=mode,
                              coarse_x=coarse_x_global,
                              coarse_W=coarse_W_global)
    batch = pad_subgraphs(specs, y=y, train_mask=train_mask,
                          val_mask=val_mask, test_mask=test_mask,
                          node_pad_to=node_pad_to, edge_pad_to=edge_pad_to)
    return PartitionedDataset(parent=parent, coarse=coarse, subgraphs=batch,
                              num_metanodes=num_meta)


def _assemble_coarse(W, comp_results, x, y, task, num_classes,
                     train_mask, val_mask, min_coarsen_size,
                     node_pad_to, edge_pad_to) -> Optional[CoarseData]:
    if train_mask is None:
        train_mask = np.ones(x.shape[0], dtype=bool)
    if val_mask is None:
        val_mask = np.zeros(x.shape[0], dtype=bool)
    feats, e_s, e_r, yt, mt, yv, mv = [], [], [], [], [], [], []
    node_off = 0
    y = np.asarray(y)
    y_width = y.shape[1:] if y.ndim > 1 else ()
    for comp, res in comp_results:
        h_tr, h_va = train_mask[comp], val_mask[comp]
        if not (h_tr.any() or h_va.any()):
            continue
        if res is not None and len(comp) > min_coarsen_size:
            n = res.num_coarse
            feats.append(coarsen_features(x[comp], res.parent))
            coo = res.Wc.tocoo()
            e_s.append(coo.row + node_off)
            e_r.append(coo.col + node_off)
            if task == "classification":
                lt, mt_ = coarse_labels_and_masks(
                    res.parent, y[comp], h_tr, num_classes)
                lv, mv_ = coarse_labels_and_masks(
                    res.parent, y[comp], h_va, num_classes)
                yt.append(lt)
                yv.append(lv)
            else:
                C = coarsening_matrix(res.parent)
                yc = np.asarray(C @ y[comp].reshape(len(comp), -1)).reshape(
                    (n,) + y_width)
                yt.append(yc)
                yv.append(yc)
                # regression: any metanode containing a train/val node trains
                mt_ = np.zeros(n, dtype=bool)
                mv_ = np.zeros(n, dtype=bool)
                np.logical_or.at(mt_, res.parent, h_tr)
                np.logical_or.at(mv_, res.parent, h_va)
            mt.append(mt_)
            mv.append(mv_)
            node_off += n
        else:
            n = len(comp)
            feats.append(x[comp])
            sub = sp.triu(W[comp][:, comp], k=1).tocoo()
            e_s.append(np.concatenate([sub.row, sub.col]) + node_off)
            e_r.append(np.concatenate([sub.col, sub.row]) + node_off)
            yt.append(y[comp])
            yv.append(y[comp])
            mt.append(h_tr)
            mv.append(h_va)
            node_off += n

    if node_off == 0:
        return None

    xs = np.concatenate(feats, axis=0).astype(np.float32)
    senders = (np.concatenate(e_s) if e_s else np.empty(0)).astype(np.int32)
    receivers = (np.concatenate(e_r) if e_r else np.empty(0)).astype(np.int32)
    g = build_graph(xs, senders, receivers, undirected=True, self_loops=True,
                    normalize=True, node_pad_to=node_pad_to,
                    edge_pad_to=edge_pad_to)
    n_pad = g.num_nodes_padded

    def pad1(a, fill=0):
        a = np.concatenate(a, axis=0)
        out = np.full((n_pad,) + a.shape[1:], fill, dtype=a.dtype)
        out[:node_off] = a
        if out.dtype == np.float64:
            # the JAX package's arrays are float32 (jax_enable_x64 off)
            out = out.astype(np.float32)
        return torch.from_numpy(out)

    return CoarseData(
        graph=g,
        y_train=pad1(yt), train_mask=pad1(mt, fill=False),
        y_val=pad1(yv), val_mask=pad1(mv, fill=False))
