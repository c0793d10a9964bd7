"""Graph-level task pipeline: per-graph coarsening and batched Gc/Gs views.

The port of the JAX package's ``data/graph_level.py``: each graph is
coarsened on the host (per connected component, as the node pipeline) into
its coarse view and its metanode subgraphs (``prepare_graph_sample``); a
split is then collated into

* a block-diagonal padded coarse ``Graph`` with one sample id per node
  (the PyG ``Batch`` / ``global_*_pool`` pattern), and
* one ``SubgraphBatch`` holding every sample's subgraphs with one sample
  id per node slot,

so each training step runs on fixed shapes.  The arrays are built in numpy
exactly as the JAX package builds them and become CPU tensors at the end;
``GraphLevelBatch.to(device)`` moves a collated split.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from fitgnn_tpu_torch.coarsen import (coarsen, coarsen_features,
                                      connected_components)
from fitgnn_tpu_torch.graph.build import (_round_up, add_self_loops,
                                          gcn_normalize, sort_by_receiver)
from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch
from fitgnn_tpu_torch.partition.subgraphs import (SubgraphSpec,
                                                  extract_subgraphs,
                                                  pad_subgraphs)
from fitgnn_tpu_torch.utils.device import to_device


@dataclasses.dataclass
class GraphSample:
    """One graph's Gc and Gs views (host-side numpy)."""

    coarse_x: np.ndarray                  # (nc, F)
    coarse_senders: np.ndarray            # undirected both-dir local edges
    coarse_receivers: np.ndarray
    subgraphs: List[SubgraphSpec]
    y: np.ndarray                         # () int label or (T,) targets


def prepare_graph_sample(x: np.ndarray, senders: np.ndarray,
                         receivers: np.ndarray, y,
                         reduction: float = 0.5,
                         method: str = "variation_neighborhoods",
                         mode: str = "plain", K: int = 10,
                         seed: int = 0) -> GraphSample:
    """Coarsen one graph (per connected component, like the node pipeline)
    and build its metanode subgraphs in ``mode``."""
    n = x.shape[0]
    w = np.ones(len(senders), dtype=np.float64)
    W = sp.csr_matrix((w, (senders, receivers)), shape=(n, n))
    W = W + W.T
    W.data[:] = np.minimum(W.data, 1.0)
    W.setdiag(0)
    W.eliminate_zeros()

    comps = connected_components(W)
    parent = np.full(n, -1, dtype=np.int64)
    offset = 0
    cxs, ces, cer = [], [], []
    for comp in comps:
        if len(comp) > 1:
            res = coarsen(W[comp][:, comp], r=reduction, method=method, K=K,
                          seed=seed)
            parent[comp] = res.parent + offset
            cxs.append(coarsen_features(x[comp], res.parent))
            coo = res.Wc.tocoo()
            ces.append(coo.row + offset)
            cer.append(coo.col + offset)
            offset += res.num_coarse
        else:
            parent[comp] = offset
            cxs.append(x[comp])
            offset += 1
    coarse_x = np.concatenate(cxs, axis=0).astype(np.float32) if cxs \
        else np.zeros((0, x.shape[1]), dtype=np.float32)
    cs = np.concatenate(ces).astype(np.int64) if ces else np.empty(0, np.int64)
    cr = np.concatenate(cer).astype(np.int64) if cer else np.empty(0, np.int64)

    num_meta = offset
    coarse_W = sp.csr_matrix(
        (np.ones(len(cs)), (cs, cr)), shape=(num_meta, num_meta))
    specs = extract_subgraphs(W, x, parent, mode=mode, coarse_x=coarse_x,
                              coarse_W=coarse_W)
    return GraphSample(coarse_x=coarse_x, coarse_senders=cs,
                       coarse_receivers=cr, subgraphs=specs,
                       y=np.asarray(y))


@dataclasses.dataclass
class GraphLevelBatch:
    """A collated split (or chunk of one): everything a graph-level step
    needs, as tensors."""

    gc: Graph                      # block-diagonal coarse graphs, padded
    gc_graph_ids: torch.Tensor     # (N_pad,) int32 sample id per coarse node
    gs: SubgraphBatch              # all samples' subgraphs stacked
    gs_graph_ids: torch.Tensor     # (S, N_sub_pad) int32 sample id per slot
    y: torch.Tensor                # (B,) int64 labels or (B[, T]) float32
    num_graphs: int
    graph_mask: torch.Tensor       # (B,) bool; False on padding samples

    def to(self, device) -> "GraphLevelBatch":
        """The same batch, every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: to_device(getattr(self, f.name), device)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class _PadTargets:
    """Shared padded shapes, so every chunk of a split has one shape."""

    num_graphs: int
    gc_nodes: int
    gc_edges: int
    num_subgraphs: int
    sub_nodes: int
    sub_edges: int


def _targets(y: np.ndarray) -> torch.Tensor:
    """Integer labels as int64 (the loss gathers with them), float targets
    as float32."""
    if np.issubdtype(y.dtype, np.integer) or y.dtype == np.bool_:
        return torch.from_numpy(y.astype(np.int64))
    return torch.from_numpy(y.astype(np.float32))


def collate_graph_level(samples: Sequence[GraphSample],
                        node_pad_to: int = 8,
                        edge_pad_to: int = 128,
                        pad: Optional[_PadTargets] = None
                        ) -> GraphLevelBatch:
    """Collate ``samples`` into one ``GraphLevelBatch``; ``pad`` forces the
    padded shapes (``compute_pad_targets``) and pads the sample axis with
    empty samples that ``graph_mask`` marks False."""
    b = len(samples)
    if b == 0:
        raise ValueError("collate_graph_level: no samples")
    feat = samples[0].coarse_x.shape[1]

    # ---- Gc block-diagonal assembly --------------------------------------
    total = sum(s.coarse_x.shape[0] for s in samples)
    xs = np.zeros((total, feat), dtype=np.float32)
    gids = np.zeros(total, dtype=np.int32)
    e_s, e_r = [], []
    off = 0
    for i, smp in enumerate(samples):
        nc = smp.coarse_x.shape[0]
        xs[off:off + nc] = smp.coarse_x
        gids[off:off + nc] = i
        e_s.append(smp.coarse_senders + off)
        e_r.append(smp.coarse_receivers + off)
        off += nc
    senders = np.concatenate(e_s) if e_s else np.empty(0, np.int64)
    receivers = np.concatenate(e_r) if e_r else np.empty(0, np.int64)

    # the edges are undirected in both directions already: self loops,
    # then the symmetric normalization
    senders, receivers, w = add_self_loops(
        senders.astype(np.int64), receivers.astype(np.int64),
        np.ones(len(senders), dtype=np.float32), total)
    w = gcn_normalize(senders, receivers, w, total)
    senders, receivers, w = sort_by_receiver(senders, receivers, w)

    n_pad = max(_round_up(total + 1, node_pad_to), node_pad_to)
    e_pad = max(_round_up(max(len(senders), 1), edge_pad_to), edge_pad_to)
    if pad is not None:
        if pad.gc_nodes < n_pad or pad.gc_edges < e_pad:
            raise ValueError(f"pad targets {pad} below the chunk's "
                             f"({n_pad}, {e_pad})")
        n_pad, e_pad = pad.gc_nodes, pad.gc_edges
    xp = np.zeros((n_pad, feat), dtype=np.float32)
    xp[:total] = xs
    sp_ = np.full(e_pad, n_pad - 1, dtype=np.int32)
    rp = np.full(e_pad, n_pad - 1, dtype=np.int32)
    wp = np.zeros(e_pad, dtype=np.float32)
    sp_[:len(senders)] = senders
    rp[:len(senders)] = receivers
    wp[:len(w)] = w
    gp = np.zeros(n_pad, dtype=np.int32)
    gp[:total] = gids

    gc = Graph(x=torch.from_numpy(xp), senders=torch.from_numpy(sp_),
               receivers=torch.from_numpy(rp), edge_weight=torch.from_numpy(wp),
               n_node=torch.tensor(total, dtype=torch.int32),
               n_edge=torch.tensor(len(senders), dtype=torch.int32))

    # ---- Gs stacked subgraphs --------------------------------------------
    all_specs: List[SubgraphSpec] = []
    spec_gid: List[int] = []
    for i, smp in enumerate(samples):
        all_specs.extend(smp.subgraphs)
        spec_gid.extend([i] * len(smp.subgraphs))
    gs = pad_subgraphs(
        all_specs, node_pad_to=node_pad_to, edge_pad_to=edge_pad_to,
        pad_nodes_to=None if pad is None else pad.sub_nodes,
        pad_edges_to=None if pad is None else pad.sub_edges,
        pad_count_to=None if pad is None else pad.num_subgraphs)
    gid_col = np.zeros(gs.num_subgraphs, dtype=np.int32)
    gid_col[:len(spec_gid)] = spec_gid
    gs_gids = np.repeat(gid_col[:, None], gs.num_nodes_padded, axis=1)

    b_pad = b if pad is None else max(pad.num_graphs, b)
    y = np.stack([s.y for s in samples])
    if b_pad > b:
        y = np.concatenate(
            [y, np.zeros((b_pad - b,) + y.shape[1:], dtype=y.dtype)])
    return GraphLevelBatch(
        gc=gc, gc_graph_ids=torch.from_numpy(gp), gs=gs,
        gs_graph_ids=torch.from_numpy(gs_gids), y=_targets(y),
        num_graphs=b_pad, graph_mask=torch.arange(b_pad) < b)


def compute_pad_targets(chunks: Sequence[Sequence[GraphSample]],
                        node_pad_to: int = 8,
                        edge_pad_to: int = 128) -> _PadTargets:
    """The shape envelope of a list of chunks (the max of each dimension),
    so that every chunk collates to one shape."""
    gc_n = gc_e = sub_n = sub_e = n_sub = n_g = 0
    for chunk in chunks:
        total = sum(s.coarse_x.shape[0] for s in chunk)
        edges = sum(len(s.coarse_senders) for s in chunk) + total  # + loops
        gc_n = max(gc_n, _round_up(total + 1, node_pad_to))
        gc_e = max(gc_e, _round_up(max(edges, 1), edge_pad_to))
        n_g = max(n_g, len(chunk))
        specs = [spec for s in chunk for spec in s.subgraphs]
        n_sub = max(n_sub, len(specs))
        mx_n = max(spec.num_nodes for spec in specs)
        sub_n = max(sub_n, _round_up(mx_n + 1, node_pad_to))
        # the edges are symmetric already; + one self loop a node
        mx_e = max(len(spec.senders) + spec.num_nodes for spec in specs)
        sub_e = max(sub_e, _round_up(max(mx_e, 1), edge_pad_to))
    return _PadTargets(num_graphs=n_g, gc_nodes=gc_n, gc_edges=gc_e,
                       num_subgraphs=n_sub, sub_nodes=sub_n, sub_edges=sub_e)


def collate_graph_level_batches(samples: Sequence[GraphSample],
                                batch_size: int,
                                node_pad_to: int = 8,
                                edge_pad_to: int = 128
                                ) -> List[GraphLevelBatch]:
    """Chunk ``samples`` into minibatches of ``batch_size`` graphs, all
    collated to one shared shape (the reference's ``DataLoader(...,
    batch_size, collate_fn=colater())``); ``batch_size`` ≤ 0 or ≥ the
    sample count gives one batch."""
    if batch_size <= 0 or batch_size >= len(samples):
        return [collate_graph_level(samples, node_pad_to, edge_pad_to)]
    chunks = [samples[i:i + batch_size]
              for i in range(0, len(samples), batch_size)]
    pad = compute_pad_targets(chunks, node_pad_to, edge_pad_to)
    return [collate_graph_level(c, node_pad_to, edge_pad_to, pad=pad)
            for c in chunks]
