"""Hierarchical halo exchange, as the JAX package's
``parallel/hierarchical.py``: exact boundary rows within a host, cluster
summary rows between hosts.

* edges whose sender lives on the same shard → aggregated locally, by the
  rank's own hybrid operator (the single-device path's K3 and K1 for GCN,
  SAGE and GIN; GAT's attention tiles);
* edges whose sender lives on another shard of the SAME host → exact
  1-hop halo rows, moved by one all-to-all over the chip group;
* edges whose sender lives on ANOTHER host → redirected to that sender's
  cluster-summary row (mean, or the reference's ``C·X`` partial isometry),
  recomputed from each layer's activations and gathered over the chip
  group and then the host group, so only ``clusters·F`` values a shard
  cross hosts.

With one host there are no summary edges and the layer computes the exact
sharded aggregation.

The port runs one rank a shard (``torch.distributed``; NCCL on the card,
gloo on the CPU).  ``build_hier_plan`` builds the exchange tables of every
shard on the host, as the JAX package does, in numpy with the shard axis
in front; ``HierPlan.local`` moves one rank's slices to its device and
builds that rank's interior operator alone.  The JAX package stacks the
P interior operators and pads every leaf to uniform shapes
(``_stack_shard_hybrids``), with zero tiles, zero-weight chunks and
zero-weight edges, because ``shard_map`` needs one shape across shards;
that padding is inert, and a rank holding its own unpadded operator needs
none (the parity tests hold the two against each other).  The collectives
run one after the other, before the interior aggregation, in the JAX
package's order; nothing here overlaps them with it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from fitgnn_tpu_torch.models.layers import GATConv
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.ops.hybrid_spmm import (HybridSpmm, build_hybrid,
                                              hybrid_spmm)
from fitgnn_tpu_torch.ops.segment import (segment_softmax, segment_sum,
                                          take_rows)
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention
from fitgnn_tpu_torch.parallel.collectives import (all_reduce_grads,
                                                   all_reduce_sum,
                                                   gather_summaries,
                                                   halo_exchange)
from fitgnn_tpu_torch.parallel.mesh import HierMesh
from fitgnn_tpu_torch.train.losses import (task_loss_sums,
                                           task_metric_from_sums,
                                           task_metric_sums)

_NEG = -1e30

# the tables a rank takes to its device, each indexed by its shard
_TABLES = ("int_senders", "int_receivers", "int_weights", "halo_senders",
           "halo_receivers", "halo_weights", "send_idx", "send_mask",
           "sum_senders", "sum_receivers", "sum_weights", "cluster_local",
           "cluster_scale")


@dataclasses.dataclass
class HierPlan:
    """Static exchange plan for a (num_hosts × chips_per_host) mesh, every
    shard's tables with the shard axis P = H·D in front (numpy).

    Shard ``p`` sits at (host ``p // D``, chip ``p % D``); its edges are
    split three ways.  ``interior`` holds the ``build_hybrid`` arguments of
    the rank-local interior operator, or is None for the per-edge
    interior."""

    # interior edges: sender and receiver local to the shard
    int_senders: np.ndarray       # (P, Ei) local row ids
    int_receivers: np.ndarray     # (P, Ei) local row ids
    int_weights: np.ndarray       # (P, Ei)
    int_counts: np.ndarray        # (P,) each list's edges before padding
    # same-host halo edges: sender indexes the (D·K, F) halo table
    halo_senders: np.ndarray      # (P, Eh) index into halo table
    halo_receivers: np.ndarray    # (P, Eh) local row ids
    halo_weights: np.ndarray      # (P, Eh)
    send_idx: np.ndarray          # (P, D, K) local rows sent to same-host peers
    send_mask: np.ndarray         # (P, D, K) bool
    # remote-host edges: sender indexes the (P·C, F) summary table
    sum_senders: np.ndarray       # (P, Es) index into summary table
    sum_receivers: np.ndarray     # (P, Es) local row ids
    sum_weights: np.ndarray       # (P, Es)
    # cluster membership (for building the summaries each layer)
    cluster_local: np.ndarray     # (P, n_loc) local cluster slot; C = padding
    cluster_scale: np.ndarray     # (P, C) per-cluster scale (1/n or 1/√n)
    num_hosts: int
    chips_per_host: int
    interior: Optional[dict] = None

    @property
    def num_shards(self) -> int:
        return self.int_senders.shape[0]

    @property
    def nodes_per_shard(self) -> int:
        return self.cluster_local.shape[1]

    @property
    def clusters_per_shard(self) -> int:
        return self.cluster_scale.shape[1]

    @property
    def halo_k(self) -> int:
        return self.send_idx.shape[-1]

    def interior_hybrid(self, p: int) -> Optional[HybridSpmm]:
        """Shard ``p``'s interior operator (CPU tensors), built from its
        interior edge list as the JAX package's ``_stack_shard_hybrids``
        builds each shard's: rows padded to a multiple of 128, K3 for the
        stragglers of the static semantics, no dynamic-tile plan."""
        if self.interior is None:
            return None
        n = int(self.int_counts[p])
        n_loc = self.nodes_per_shard
        return build_hybrid(
            self.int_senders[p, :n].astype(np.int64),
            self.int_receivers[p, :n].astype(np.int64),
            self.int_weights[p, :n].astype(np.float32),
            -(-n_loc // 128) * 128, real_nodes=n_loc, build_dyn=False,
            **self.interior)

    def local(self, mesh: HierMesh, device) -> "RankPlan":
        """This rank's slices on ``device`` and its interior operator."""
        p = mesh.rank
        t = {}
        for name in _TABLES:
            a = np.ascontiguousarray(getattr(self, name)[p])
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            t[name] = torch.from_numpy(a).to(device)
        hyb = self.interior_hybrid(p)
        return RankPlan(mesh=mesh,
                        int_hybrid=None if hyb is None else hyb.to(device),
                        **t)


@dataclasses.dataclass
class RankPlan:
    """One rank's slices of a ``HierPlan`` on its device, with its mesh
    and its interior operator (None: the per-edge interior)."""

    mesh: HierMesh
    int_hybrid: Optional[HybridSpmm]
    int_senders: torch.Tensor
    int_receivers: torch.Tensor
    int_weights: torch.Tensor
    halo_senders: torch.Tensor
    halo_receivers: torch.Tensor
    halo_weights: torch.Tensor
    send_idx: torch.Tensor
    send_mask: torch.Tensor
    sum_senders: torch.Tensor
    sum_receivers: torch.Tensor
    sum_weights: torch.Tensor
    cluster_local: torch.Tensor
    cluster_scale: torch.Tensor


def _pad2(rows, fill, width, dtype):
    out = np.full((len(rows), width), fill, dtype=dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def build_hier_plan(senders_global: np.ndarray, receivers_local: np.ndarray,
                    edge_weight: np.ndarray, num_hosts: int,
                    chips_per_host: int, nodes_per_shard: int,
                    cluster_of: np.ndarray, summary: str = "mean",
                    pad_to: int = 8,
                    interior_hybrid: bool = True,
                    min_block_edges: int = 150,
                    interior_semantics: str = "gcn_norm",
                    interior_cluster: int = 0,
                    interior_cluster_exact: int = 0) -> HierPlan:
    """Build the three-way edge split + exchange tables (host-side).

    ``senders_global``/``receivers_local``/``edge_weight``: the
    ``ShardedGraph`` layout — (P, E) with global senders, local receivers.
    ``cluster_of``: (N_global,) cluster id per node; every cluster must live
    entirely on one shard (community-contiguous placement guarantees this).
    ``summary``: "mean" (Σx/n) or "isometry" (the reference's C·X rows,
    Σx/√n).  ``interior_hybrid``: the interior runs on each rank's hybrid
    operator at ``min_block_edges`` under ``interior_semantics``, with
    ``interior_cluster`` / ``interior_cluster_exact`` the straggler
    collapse (``cluster_att`` for ``att_unit``, else ``cluster_agg``).
    """
    P = num_hosts * chips_per_host
    assert senders_global.shape[0] == P, (senders_global.shape, P)
    n_loc = nodes_per_shard
    D = chips_per_host
    s_all = np.asarray(senders_global, dtype=np.int64)
    r_all = np.asarray(receivers_local, dtype=np.int64)
    w_all = np.asarray(edge_weight)
    cluster_of = np.asarray(cluster_of, dtype=np.int64)
    n_global = len(cluster_of)

    # per-shard cluster slot tables (clusters are shard-contiguous)
    shard_clusters = []      # sorted unique cluster ids per shard
    for p in range(P):
        lo, hi = p * n_loc, min((p + 1) * n_loc, n_global)
        ids = np.unique(cluster_of[lo:hi]) if hi > lo else np.empty(0, np.int64)
        shard_clusters.append(ids)
    owner_of_cluster = np.full(int(cluster_of.max()) + 1 if n_global else 1,
                               -1, dtype=np.int64)
    for p, ids in enumerate(shard_clusters):
        for c in ids:
            if owner_of_cluster[c] not in (-1, p):
                raise ValueError(
                    f"cluster {c} spans shards {owner_of_cluster[c]} and {p}"
                    " — use community-contiguous node ordering")
            owner_of_cluster[c] = p
    C = max((len(i) for i in shard_clusters), default=1)
    C = max(((C + pad_to - 1) // pad_to) * pad_to, pad_to)

    cluster_local = np.full((P, n_loc), C, dtype=np.int32)  # C = padding slot
    cluster_scale = np.zeros((P, C), dtype=np.float32)
    for p, ids in enumerate(shard_clusters):
        lo, hi = p * n_loc, min((p + 1) * n_loc, n_global)
        if hi <= lo:
            continue
        slots = np.searchsorted(ids, cluster_of[lo:hi])
        cluster_local[p, : hi - lo] = slots
        counts = np.bincount(slots, minlength=C).astype(np.float32)
        nz = counts > 0
        cluster_scale[p, nz] = (1.0 / counts[nz] if summary == "mean"
                                else 1.0 / np.sqrt(counts[nz]))

    # halo need lists (same-host pairs only)
    need = [[None] * D for _ in range(P)]   # need[q][d] = rows from chip d
    for q in range(P):
        h = q // D
        owner = s_all[q] // n_loc
        for d in range(D):
            p = h * D + d
            if p == q:
                need[q][d] = np.empty(0, np.int64)
                continue
            rows = np.unique(s_all[q][owner == p]) % n_loc
            need[q][d] = rows
    k = max((len(need[q][d]) for q in range(P) for d in range(D)), default=1)
    k = max(((k + pad_to - 1) // pad_to) * pad_to, pad_to)

    send_idx = np.zeros((P, D, k), dtype=np.int32)
    send_mask = np.zeros((P, D, k), dtype=bool)
    for p in range(P):
        hp, dp = p // D, p % D
        for d in range(D):
            q = hp * D + d
            if q == p:
                continue
            rows = need[q][dp]
            send_idx[p, d, : len(rows)] = rows
            send_mask[p, d, : len(rows)] = True

    # three-way edge split per shard
    ints, intr, intw = [], [], []
    has_, har_, haw_ = [], [], []
    sus_, sur_, suw_ = [], [], []
    for q in range(P):
        hq = q // D
        s, r, w = s_all[q], r_all[q], w_all[q]
        owner = s // n_loc
        local = owner == q
        samehost = (owner // D == hq) & ~local
        remote = ~local & ~samehost

        ints.append(s[local] % n_loc)
        intr.append(r[local])
        intw.append(w[local])

        sh = s[samehost]
        oh = owner[samehost]
        ext = np.zeros(len(sh), dtype=np.int64)
        for d in range(D):
            p = hq * D + d
            sel = oh == p
            if not sel.any():
                continue
            pos = np.searchsorted(need[q][d], sh[sel] % n_loc)
            ext[sel] = d * k + pos
        has_.append(ext)
        har_.append(r[samehost])
        haw_.append(w[samehost])

        sr = s[remote]
        orm = owner[remote]
        slot = np.zeros(len(sr), dtype=np.int64)
        for pv in np.unique(orm):          # vectorized per owner shard
            sel = orm == pv
            slot[sel] = pv * C + np.searchsorted(shard_clusters[pv],
                                                 cluster_of[sr[sel]])
        sus_.append(slot)
        sur_.append(r[remote])
        suw_.append(w[remote])

    def pad_edges(s_lists, r_lists, w_lists):
        e = max(max((len(a) for a in s_lists), default=0), 1)
        e = ((e + pad_to - 1) // pad_to) * pad_to
        return (_pad2(s_lists, 0, e, np.int32),
                _pad2(r_lists, n_loc - 1, e, np.int32),
                _pad2(w_lists, 0.0, e, np.float32))

    is_, ir_, iw_ = pad_edges(ints, intr, intw)
    hs_, hr_, hw_ = pad_edges(has_, har_, haw_)
    ss_, sr2, sw_ = pad_edges(sus_, sur_, suw_)

    interior = None
    if interior_hybrid:
        # the straggler collapse is attention's under att_unit, else the
        # static weights'
        att = interior_semantics == "att_unit"
        interior = dict(
            min_block_edges=min_block_edges, use_segmm=not att,
            semantics=interior_semantics,
            cluster_att=interior_cluster if att else 0,
            cluster_att_exact=interior_cluster_exact if att else 0,
            cluster_agg=0 if att else interior_cluster,
            cluster_agg_exact=0 if att else interior_cluster_exact)

    return HierPlan(
        int_senders=is_, int_receivers=ir_, int_weights=iw_,
        int_counts=np.array([len(a) for a in ints], dtype=np.int64),
        halo_senders=hs_, halo_receivers=hr_, halo_weights=hw_,
        send_idx=send_idx, send_mask=send_mask,
        sum_senders=ss_, sum_receivers=sr2, sum_weights=sw_,
        cluster_local=cluster_local, cluster_scale=cluster_scale,
        num_hosts=num_hosts, chips_per_host=chips_per_host,
        interior=interior)


def _hier_tables(h: torch.Tensor, plan: RankPlan):
    """Both collectives of one layer: the (D·K, F) halo table and the
    (P·C, F) summary table the plan's sender indices point into."""
    C = plan.cluster_scale.shape[0]
    buf = (take_rows(h, plan.send_idx.reshape(-1)).reshape(
        plan.send_idx.shape + (h.shape[-1],))
        * plan.send_mask[..., None].to(h.dtype))
    halo = halo_exchange(buf, plan.mesh)
    sums = segment_sum(h, plan.cluster_local, C + 1)[:C]
    local_summary = sums * plan.cluster_scale[:, None].to(h.dtype)
    return halo, gather_summaries(local_summary, plan.mesh)


def _pad_rows(h: torch.Tensor, n: int) -> torch.Tensor:
    return F.pad(h, (0, 0, 0, n - h.shape[0])) if n != h.shape[0] else h


def hier_aggregate(h: torch.Tensor, plan: RankPlan) -> torch.Tensor:
    """One rank's hierarchical aggregation of its activations ``h``
    (n_loc, F): the interior through its operator (or per edge), then the
    halo and summary edges."""
    n_loc = h.shape[0]
    halo, summaries = _hier_tables(h, plan)
    hyb = plan.int_hybrid
    if hyb is not None:
        # the single-device operator, rank-local: K3's stragglers and K1's
        # tiles
        out = hybrid_spmm(hyb, _pad_rows(h, hyb.num_nodes))[:n_loc]
    else:
        out = segment_sum(take_rows(h, plan.int_senders)
                          * plan.int_weights[:, None].to(h.dtype),
                          plan.int_receivers, n_loc)
    out = out + segment_sum(take_rows(halo, plan.halo_senders)
                            * plan.halo_weights[:, None].to(h.dtype),
                            plan.halo_receivers, n_loc)
    return out + segment_sum(take_rows(summaries, plan.sum_senders)
                             * plan.sum_weights[:, None].to(h.dtype),
                             plan.sum_receivers, n_loc)


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


def hier_attention_aggregate(h: torch.Tensor, plan: RankPlan,
                             a_src: torch.Tensor, a_dst: torch.Tensor,
                             negative_slope: float) -> torch.Tensor:
    """One rank's hierarchical GAT aggregation: a per-receiver softmax over
    the three edge classes together, with remote-host senders represented
    by their cluster-summary rows (scores computed ON the summary rows).
    On an ``att_unit`` interior operator the interior edges take the tile
    attention (``_hier_tile_attention``)."""
    hyb = plan.int_hybrid
    if hyb is not None and hyb.semantics == "att_unit":
        return _hier_tile_attention(h, plan, a_src, a_dst, negative_slope)
    n_loc = h.shape[0]
    halo, summaries = _hier_tables(h, plan)
    table = torch.cat([h, halo, summaries], dim=0)
    senders = torch.cat([plan.int_senders, plan.halo_senders + n_loc,
                         plan.sum_senders + n_loc + halo.shape[0]])
    receivers = torch.cat([plan.int_receivers, plan.halo_receivers,
                           plan.sum_receivers])
    mask = torch.cat([plan.int_weights, plan.halo_weights,
                      plan.sum_weights]) > 0
    y = take_rows(table, senders)                              # (E, C)
    ssrc = y.float() @ a_src.float()                           # (E,)
    sdst = take_rows(h.float() @ a_dst.float(), receivers)
    pre = _leaky(ssrc + sdst, negative_slope)
    alpha = segment_softmax(pre, receivers, n_loc, mask=mask)
    return segment_sum(y * alpha[:, None].to(y.dtype), receivers, n_loc)


def _raw_segment_max(v: torch.Tensor, ids: torch.Tensor,
                     n: int) -> torch.Tensor:
    """Segment max whose empty segments are −inf (``jax.ops.segment_max``);
    ``ops.segment.segment_max`` makes them 0, which would force m ≥ 0 on a
    receiver without external edges and defeat the exact max."""
    out = torch.full((n,), float("-inf"), dtype=v.dtype, device=v.device)
    return out.scatter_reduce(0, ids, v, "amax", include_self=True)


def _hier_tile_attention(h: torch.Tensor, plan: RankPlan,
                         a_src: torch.Tensor, a_dst: torch.Tensor,
                         negative_slope: float) -> torch.Tensor:
    """Hier GAT with the interior edges on the tile attention operator
    (``tile_gat_attention(partials=True)``, the single-device GAT's path)
    and the halo and summary edges per edge, in ONE per-receiver softmax:
    both parts share a stabilizer ``m`` that bounds every sender table
    (local, halo, summary), so the combined normalization is exact."""
    hyb = plan.int_hybrid
    n_loc = h.shape[0]
    n_pad = hyb.num_nodes
    halo, summaries = _hier_tables(h, plan)
    f32 = torch.float32
    a_s, a_d = a_src.to(f32), a_dst.to(f32)
    hp = _pad_rows(h, n_pad)
    s_src = hp.to(f32) @ a_s                                  # (n_pad,)
    s_dst = hp.to(f32) @ a_d
    s_src_halo = halo.to(f32) @ a_s                           # (D·K,)
    s_src_sum = summaries.to(f32) @ a_s                       # (P·C,)

    # one bound covering EVERY sender table (padding rows score 0, which
    # the global-max stabilizer's clamp at 0 already allows)
    bound = torch.maximum(s_src.max(), torch.maximum(
        s_src_halo.max(), s_src_sum.max())).detach()

    # per-edge scores of the halo and summary classes, masked BEFORE the
    # exp (an over-m padding score would exp to inf, and 0·inf = NaN under
    # the exact max)
    mask_h = plan.halo_weights > 0
    mask_s = plan.sum_weights > 0
    sdst_loc = s_dst[:n_loc]
    es_h = torch.where(mask_h, _leaky(
        take_rows(s_src_halo, plan.halo_senders)
        + take_rows(sdst_loc, plan.halo_receivers), negative_slope), _NEG)
    es_s = torch.where(mask_s, _leaky(
        take_rows(s_src_sum, plan.sum_senders)
        + take_rows(sdst_loc, plan.sum_receivers), negative_slope), _NEG)
    with torch.no_grad():
        ext_m = torch.full((n_pad,), _NEG, dtype=f32, device=h.device)
        ext_m[:n_loc] = torch.maximum(
            _raw_segment_max(es_h, plan.halo_receivers, n_loc),
            _raw_segment_max(es_s, plan.sum_receivers, n_loc)
        ).clamp_min(_NEG)                           # −inf → finite floor

    num, den, m = tile_gat_attention(hyb, s_src, s_dst, hp, negative_slope,
                                     att_src=a_src, partials=True,
                                     src_score_bound=bound,
                                     extra_rowmax=ext_m)
    num, den, m = num[:n_loc], den[:n_loc], m[:n_loc]

    pes_h = torch.exp(es_h - take_rows(m, plan.halo_receivers)) * mask_h
    pes_s = torch.exp(es_s - take_rows(m, plan.sum_receivers)) * mask_s
    num = num + segment_sum(take_rows(halo, plan.halo_senders)
                            * pes_h[:, None].to(h.dtype),
                            plan.halo_receivers, n_loc)
    num = num + segment_sum(take_rows(summaries, plan.sum_senders)
                            * pes_s[:, None].to(h.dtype),
                            plan.sum_receivers, n_loc)
    den = den + segment_sum(pes_h, plan.halo_receivers, n_loc)
    den = den + segment_sum(pes_s, plan.sum_receivers, n_loc)
    return num / den.clamp_min(1e-16).to(h.dtype)[:, None]


class HierNodeModel(NodeModel):
    """``NodeModel`` over a rank's ``RankPlan``: the same layers and
    parameter names (``convs.layers.<i>.*``, ``head.*``), so one state dict
    loads into either, and ``models.convert.params_from_flax`` loads the
    JAX package's ``HierNodeModel`` tree.  Each layer runs its own dense
    work (``propagate``) around the hierarchical aggregation, so no layer
    may be pre-aggregated: ``NodeModel``'s arguments less that one."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True,
                 dropout_rate: float = 0.5, fused_dropout: bool = False,
                 bit_dropout: bool = True):
        super().__init__(layer_name, in_dim, hidden, num_layers, out_dim,
                         classify, dropout_rate, fused_dropout, bit_dropout)

    def forward(self, x: torch.Tensor, plan: RankPlan,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        def agg_for(layer):
            if isinstance(layer, GATConv):
                return lambda h, a_s, a_d: hier_attention_aggregate(
                    h, plan, a_s, a_d, layer.negative_slope)
            return lambda h: hier_aggregate(h, plan)

        return super().forward(x, None, generator, agg_for)


def hier_view(model: NodeModel) -> HierNodeModel:
    """A ``HierNodeModel`` over ``model``'s own layers and head: the same
    parameters and dropout, so an optimizer over ``model.parameters()``
    steps either, as the JAX package's hier and single-device models share
    one parameter tree."""
    view = HierNodeModel.__new__(HierNodeModel)
    torch.nn.Module.__init__(view)
    view.classify, view.dtype = model.classify, model.dtype
    view.convs, view.head = model.convs, model.head
    return view


def init_hier_params(model: HierNodeModel, seed: int) -> HierNodeModel:
    """flax's default init drawn from a ``torch.Generator`` seeded with
    ``seed``: the same parameters on every rank."""
    return model.reset_parameters(torch.Generator().manual_seed(seed))


def hier_train_step(model: HierNodeModel, opt: torch.optim.Optimizer,
                    x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                    plan: RankPlan, generator: Optional[torch.Generator],
                    task: str) -> torch.Tensor:
    """One step of the psum'd full-batch descent of the JAX package's
    ``make_hier_train_step``: the loss is this rank's masked sum over the
    count of every rank, every rank runs the backward (the exchanges'
    backward passes are collectives), the gradients are summed over the
    ranks, then Adam with L2 steps.  Returns the summed loss."""
    model.train()
    opt.zero_grad(set_to_none=True)
    out = model(x, plan, generator)
    local_sum, local_cnt = task_loss_sums(task, out, y, mask)
    loss = local_sum / all_reduce_sum(local_cnt).clamp_min(1.0)
    loss.backward()
    all_reduce_grads(model.parameters())
    opt.step()
    return all_reduce_sum(loss)


def hier_eval_step(model: HierNodeModel, x: torch.Tensor, y: torch.Tensor,
                   mask: torch.Tensor, plan: RankPlan, task: str) -> tuple:
    """(loss, metric) over every rank's masked rows, as the JAX package's
    ``make_hier_eval_step``: accuracy, or the L1 over the std of the
    targets of every rank together."""
    model.eval()
    with torch.no_grad():
        out = model(x, plan)
        sums = torch.stack([v.float().reshape(()) for v in (
            *task_loss_sums(task, out, y, mask),
            *task_metric_sums(task, out, y, mask))])
        ls, c, ms, ys, y2s = all_reduce_sum(sums)
        metric = task_metric_from_sums(task, ls, c, ms, ys, y2s)
        return ls / c.clamp_min(1.0), metric


def hier_oracle_features(x: np.ndarray, senders: np.ndarray,
                         receivers: np.ndarray, weights: np.ndarray,
                         num_hosts: int, chips_per_host: int,
                         nodes_per_shard: int, cluster_of: np.ndarray,
                         summary: str = "mean") -> np.ndarray:
    """Single-device oracle of the hierarchical aggregation semantics:
    ``out[r] = Σ w_e · f(s)`` where ``f(s) = x[s]`` for same-host senders and
    the sender's cluster summary for remote-host senders.  For parity tests.
    """
    D = chips_per_host
    n = x.shape[0]
    cluster_of = np.asarray(cluster_of)
    n_clusters = int(cluster_of.max()) + 1
    sums = np.zeros((n_clusters, x.shape[1]), dtype=np.float64)
    np.add.at(sums, cluster_of, x.astype(np.float64))
    counts = np.bincount(cluster_of, minlength=n_clusters).astype(np.float64)
    scale = (1.0 / np.maximum(counts, 1) if summary == "mean"
             else 1.0 / np.sqrt(np.maximum(counts, 1)))
    summaries = sums * scale[:, None]

    out = np.zeros_like(x, dtype=np.float64)
    host_of = (np.arange(n) // nodes_per_shard) // D
    for s, r, w in zip(senders, receivers, weights):
        feat = (x[s].astype(np.float64) if host_of[s] == host_of[r]
                else summaries[cluster_of[s]])
        out[r] += w * feat
    return out.astype(x.dtype)
