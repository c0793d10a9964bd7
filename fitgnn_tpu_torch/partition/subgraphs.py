"""Metanode→subgraph extraction with the three node modes.

Array-native reimplementation of the reference's per-metanode subgraph
builder (``utils.py:143-374``), with the same capability surface:

* **plain**        — induced subgraph on each metanode's member nodes.
* **extra_node**   — members + 1-hop halo; halo nodes excluded from loss
  (``utils.py:235-239``).  Unlike the reference — whose positional mask
  misaligns with its re-sorted node list — the consume mask here marks
  exactly the member nodes.
* **cluster_node** — members + one summary node per adjacent coarse cluster,
  summary features = that cluster's coarse feature row (``C·X``), boundary
  edges node↔summary, plus summary↔summary edges where the coarse adjacency
  connects the clusters (``utils.py:191-232``).

Output is a single padded ``SubgraphBatch`` of CPU tensors (uniform
shapes, the subgraph axis first) that the layers run at once — replacing
the reference's Python list streaming.  The arrays are built in numpy
exactly as the JAX package builds them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from fitgnn_tpu_torch.graph.build import gcn_normalize, _round_up
from fitgnn_tpu_torch.graph.container import SubgraphBatch

MODES = ("plain", "extra_node", "cluster_node")


@dataclasses.dataclass
class SubgraphSpec:
    """Host-side (numpy) subgraph before padding."""

    orig_idx: np.ndarray       # (n,) global node ids; -1 for summary nodes
    consume: np.ndarray        # (n,) bool — nodes whose outputs this owns
    x: np.ndarray              # (n, F) features (summary rows appended)
    senders: np.ndarray        # (e,) local edge list (undirected, both dirs)
    receivers: np.ndarray      # (e,)

    @property
    def num_nodes(self) -> int:
        return self.orig_idx.shape[0]


def extract_subgraphs(
    W: sp.spmatrix,
    x: np.ndarray,
    parent: np.ndarray,
    mode: str = "plain",
    coarse_x: Optional[np.ndarray] = None,
    coarse_W: Optional[sp.spmatrix] = None,
) -> List[SubgraphSpec]:
    """Build one SubgraphSpec per metanode.

    ``W``: full-graph symmetric adjacency (csr).  ``parent``: (N,) global
    node→metanode map.  ``coarse_x``/``coarse_W`` required for cluster_node.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    W = sp.csr_matrix(W)
    N = W.shape[0]
    num_meta = int(parent.max()) + 1 if parent.size else 0
    if mode == "cluster_node":
        assert coarse_x is not None and coarse_W is not None, \
            "cluster_node needs coarse features and coarse adjacency"
        coarse_W = sp.csr_matrix(coarse_W)

    # ---- vectorized global precomputation (no per-metanode graph slicing;
    # the reference's per-metanode Python-dict loop is its hot spot #3) ----
    coo = W.tocoo()
    es, er = coo.row.astype(np.int64), coo.col.astype(np.int64)
    ps, pr = parent[es], parent[er]
    intra = ps == pr
    # group intra edges by metanode
    ie_s, ie_r = es[intra], er[intra]
    ie_m = ps[intra]
    ie_order = np.argsort(ie_m, kind="stable")
    ie_s, ie_r, ie_m = ie_s[ie_order], ie_r[ie_order], ie_m[ie_order]
    ie_bounds = np.searchsorted(ie_m, np.arange(num_meta + 1))
    # group boundary edges (u → v, different metanode) by parent[u]
    be_s, be_t = es[~intra], er[~intra]
    be_m = ps[~intra]
    be_order = np.argsort(be_m, kind="stable")
    be_s, be_t, be_m = be_s[be_order], be_t[be_order], be_m[be_order]
    be_bounds = np.searchsorted(be_m, np.arange(num_meta + 1))

    # members per metanode + global→core-local index
    order = np.argsort(parent, kind="stable")
    bounds = np.searchsorted(parent[order], np.arange(num_meta + 1))
    lookup = np.full(N, -1, dtype=np.int64)

    specs: List[SubgraphSpec] = []
    for m in range(num_meta):
        core = np.sort(order[bounds[m]:bounds[m + 1]])
        i_s = ie_s[ie_bounds[m]:ie_bounds[m + 1]]
        i_r = ie_r[ie_bounds[m]:ie_bounds[m + 1]]
        b_s = be_s[be_bounds[m]:be_bounds[m + 1]]
        b_t = be_t[be_bounds[m]:be_bounds[m + 1]]

        if mode == "extra_node":
            halo = np.unique(b_t)
            nodes = np.sort(np.concatenate([core, halo]))
            lookup[nodes] = np.arange(len(nodes))
            # induced edges: core-core + core↔halo + halo-halo(within set)
            # halo-halo edges are boundary edges of OTHER metanodes whose
            # endpoints both landed in this node set — recover them from the
            # halo nodes' CSR rows (small: only halo rows touched)
            hh_s, hh_r = _rows_within(W, halo, nodes, N)
            s_loc = np.concatenate([lookup[i_s], lookup[b_s], lookup[b_t],
                                    hh_s])
            r_loc = np.concatenate([lookup[i_r], lookup[b_t], lookup[b_s],
                                    hh_r])
            # dedupe (core↔halo appear once per direction already; halo rows
            # re-add halo→core duplicates)
            key = s_loc * len(nodes) + r_loc
            _, keep = np.unique(key, return_index=True)
            s_loc, r_loc = s_loc[keep], r_loc[keep]
            consume = np.zeros(len(nodes), dtype=bool)
            consume[lookup[core]] = True
            feats = x[nodes]
            orig = nodes
            lookup[nodes] = -1
        elif mode == "cluster_node":
            lookup[core] = np.arange(len(core))
            clusters, cl_inv = np.unique(parent[b_t], return_inverse=True)
            n_sum = len(clusters)
            sum_ids = len(core) + np.arange(n_sum)
            e1 = lookup[b_s]
            e2 = sum_ids[cl_inv]
            key = e1 * (len(core) + n_sum) + e2
            _, keep = np.unique(key, return_index=True)
            e1, e2 = e1[keep], e2[keep]
            ss_s = np.empty(0, dtype=np.int64)
            ss_r = np.empty(0, dtype=np.int64)
            if n_sum > 1:
                sub_cw = coarse_W[clusters][:, clusters].tocoo()
                upper = sub_cw.row < sub_cw.col
                ss_s = sum_ids[sub_cw.row[upper]]
                ss_r = sum_ids[sub_cw.col[upper]]
            s_loc = np.concatenate([lookup[i_s], e1, e2, ss_s, ss_r])
            r_loc = np.concatenate([lookup[i_r], e2, e1, ss_r, ss_s])
            feats = np.concatenate([x[core], coarse_x[clusters]], axis=0) \
                if n_sum else x[core]
            consume = np.concatenate([np.ones(len(core), dtype=bool),
                                      np.zeros(n_sum, dtype=bool)])
            orig = np.concatenate([core, np.full(n_sum, -1, dtype=np.int64)])
            lookup[core] = -1
        else:  # plain
            lookup[core] = np.arange(len(core))
            s_loc, r_loc = lookup[i_s], lookup[i_r]
            consume = np.ones(len(core), dtype=bool)
            feats = x[core]
            orig = core
            lookup[core] = -1

        specs.append(SubgraphSpec(
            orig_idx=np.asarray(orig, dtype=np.int64),
            consume=consume,
            x=np.asarray(feats, dtype=np.float32),
            senders=np.asarray(s_loc, dtype=np.int64),
            receivers=np.asarray(r_loc, dtype=np.int64)))
    return specs


def _rows_within(W: sp.csr_matrix, rows: np.ndarray, node_set: np.ndarray,
                 N: int):
    """Edges from ``rows`` to targets inside ``node_set`` (local ids)."""
    if len(rows) == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    member = np.zeros(N, dtype=bool)
    member[node_set] = True
    local = np.full(N, -1, dtype=np.int64)
    local[node_set] = np.arange(len(node_set))
    indptr, indices = W.indptr, W.indices
    out_s, out_r = [], []
    for u in rows:
        nb = indices[indptr[u]:indptr[u + 1]]
        nb = nb[member[nb]]
        if len(nb):
            out_s.append(np.full(len(nb), local[u], dtype=np.int64))
            out_r.append(local[nb].astype(np.int64))
    if not out_s:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    return np.concatenate(out_s), np.concatenate(out_r)


def pad_subgraphs(
    specs: Sequence[SubgraphSpec],
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    node_pad_to: int = 8,
    edge_pad_to: int = 128,
    self_loops: bool = True,
    normalize: bool = True,
    pad_nodes_to: Optional[int] = None,
    pad_edges_to: Optional[int] = None,
    pad_count_to: Optional[int] = None,
) -> SubgraphBatch:
    """Pad all specs to uniform static shapes and stack into a SubgraphBatch.

    Global ``y``/split masks are gathered through ``orig_idx``; halo and
    summary slots are forced out of every split (the semantic fix of the
    reference's remapping, ``utils.py:683-703``).

    ``pad_nodes_to``/``pad_edges_to``/``pad_count_to`` force the padded node
    slot count, edge slot count, and subgraph count — so several chunks share
    one compiled shape (chunked graph-level minibatching).  Extra subgraph
    slots are empty (no nodes, weight-0 edges, all-False masks).
    """
    S = len(specs)
    assert S > 0
    feat = specs[0].x.shape[1]
    max_n = max(s.num_nodes for s in specs)
    n_pad = max(_round_up(max_n + 1, node_pad_to), node_pad_to)
    if pad_nodes_to is not None:
        assert pad_nodes_to >= n_pad, (pad_nodes_to, n_pad)
        n_pad = pad_nodes_to

    # per-spec edge preprocessing first, so e_pad covers self loops
    processed = []
    for s in specs:
        snd, rcv = s.senders, s.receivers
        if self_loops:
            loop = np.arange(s.num_nodes, dtype=np.int64)
            snd = np.concatenate([snd, loop])
            rcv = np.concatenate([rcv, loop])
        w = np.ones(len(snd), dtype=np.float32)
        if normalize:
            w = gcn_normalize(snd, rcv, w, s.num_nodes)
        order_ = np.argsort(rcv, kind="stable")
        processed.append((snd[order_], rcv[order_], w[order_]))
    max_e = max(len(p[0]) for p in processed)
    e_pad = max(_round_up(max(max_e, 1), edge_pad_to), edge_pad_to)
    if pad_edges_to is not None:
        assert pad_edges_to >= e_pad, (pad_edges_to, e_pad)
        e_pad = pad_edges_to
    S_alloc = S if pad_count_to is None else max(pad_count_to, S)

    xs = np.zeros((S_alloc, n_pad, feat), dtype=np.float32)
    snds = np.full((S_alloc, e_pad), n_pad - 1, dtype=np.int32)
    rcvs = np.full((S_alloc, e_pad), n_pad - 1, dtype=np.int32)
    ws = np.zeros((S_alloc, e_pad), dtype=np.float32)
    n_node = np.zeros(S_alloc, dtype=np.int32)
    n_edge = np.zeros(S_alloc, dtype=np.int32)
    consume = np.zeros((S_alloc, n_pad), dtype=bool)
    orig = np.full((S_alloc, n_pad), -1, dtype=np.int32)

    y_shape = () if y is None else np.asarray(y).shape[1:]
    # float64 targets become float32, as the JAX package's arrays are
    y_dtype = None if y is None else np.asarray(y).dtype
    if y_dtype == np.float64:
        y_dtype = np.float32
    ys = None if y is None else np.zeros((S_alloc, n_pad) + y_shape,
                                         dtype=y_dtype)
    tr = None if train_mask is None else np.zeros((S_alloc, n_pad), dtype=bool)
    va = None if val_mask is None else np.zeros((S_alloc, n_pad), dtype=bool)
    te = None if test_mask is None else np.zeros((S_alloc, n_pad), dtype=bool)

    for k, (s, (snd, rcv, w)) in enumerate(zip(specs, processed)):
        n, e = s.num_nodes, len(snd)
        xs[k, :n] = s.x
        snds[k, :e], rcvs[k, :e], ws[k, :e] = snd, rcv, w
        n_node[k], n_edge[k] = n, e
        consume[k, :n] = s.consume
        orig[k, :n] = s.orig_idx
        real = s.orig_idx >= 0
        gidx = s.orig_idx[real]
        if ys is not None:
            ys[k, :n][real] = np.asarray(y)[gidx]
        for dst, src in ((tr, train_mask), (va, val_mask), (te, test_mask)):
            if dst is not None:
                loc = np.zeros(n, dtype=bool)
                loc[real] = np.asarray(src, dtype=bool)[gidx]
                dst[k, :n] = loc & s.consume

    def t(a):
        return None if a is None else torch.from_numpy(a)

    return SubgraphBatch(
        x=t(xs), senders=t(snds), receivers=t(rcvs), edge_weight=t(ws),
        n_node=t(n_node), n_edge=t(n_edge), consume_mask=t(consume),
        orig_idx=t(orig), y=t(ys), train_mask=t(tr), val_mask=t(va),
        test_mask=t(te))
