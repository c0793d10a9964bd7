"""Hybrid BCSR + straggler SpMM.

Community-reordered graphs put most edges inside dense 128×128 adjacency
tiles, but a tail of cut edges would fill millions of nearly-empty tiles.
The hybrid splits edges by tile occupancy:

* tiles with ≥ ``min_block_edges`` edges → dense BCSR tiles (K1,
  ``ops/bsr_spmm.py``);
* the remainder → the straggler list (K3, ``ops/coo_segmm.py``, with
  ``use_segmm``; plain COO otherwise).

The forward fuses the two: K3 writes the straggler sum and K1 accumulates
the tiles on top of it.  The backward (``dx = Aᵀ·g``) is the same chain on
the transpose structures, built as the JAX package builds them: K3 on
``t_segmm``, then K1 on ``bsr.transpose`` accumulating on it.  For GAT's
``att_unit`` operator the build also makes the dynamic-tile plan
(``ops/bsr_dynamic.py``) that the attention tiles walk.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops.bsr_dynamic import DynPlan, build_dyn_plan
from fitgnn_tpu_torch.ops.bsr_spmm import (BLOCK, BsrMatrix, build_bsr,
                                           bsr_spmm_acc)
from fitgnn_tpu_torch.ops.coo_segmm import SegCsr, build_segmm, segmm_spmm
from fitgnn_tpu_torch.ops.spmm import spmm_coo
from fitgnn_tpu_torch.utils.device import dataclass_to


@dataclasses.dataclass
class HybridSpmm:
    bsr: Optional[BsrMatrix]           # None when no tile is dense enough
    senders: torch.Tensor              # straggler COO, receiver-sorted
    receivers: torch.Tensor
    weights: torch.Tensor
    t_senders: torch.Tensor            # transpose COO (for the backward),
    t_receivers: torch.Tensor          # receiver-sorted in transpose space
    t_weights: torch.Tensor
    num_nodes: int
    segmm: Optional[SegCsr] = None     # K3 structure for the stragglers
    t_segmm: Optional[SegCsr] = None
    semantics: str = "gcn_norm"        # aggregation the weights encode
    t_edge_perm: Optional[torch.Tensor] = None  # (E,) forward-list position
                                       # of each transpose-list entry
    dyn_plan: Optional[DynPlan] = None  # walk plan of dynamic tile values
                                       # (GAT attention); att_unit only

    @property
    def num_coo_edges(self) -> int:
        return self.senders.shape[0]

    def to(self, device) -> "HybridSpmm":
        return dataclass_to(self, device)


def build_hybrid(senders: np.ndarray, receivers: np.ndarray,
                 weight: np.ndarray, num_nodes_padded: int,
                 min_block_edges: int = 150,
                 tile_dtype=None,
                 use_segmm: bool = False,
                 use_diag: bool = False,
                 use_rowwalk: bool = False,
                 tile_group: int = 1,
                 use_einsum_tiles: bool = False,
                 semantics: str = "gcn_norm",
                 cluster_att: int = 0,
                 cluster_att_exact: int = 0,
                 cluster_agg: int = 0,
                 cluster_agg_exact: int = 0) -> HybridSpmm:
    """Split edges by tile occupancy and build both structures (host-side),
    as the JAX package's ``build_hybrid`` does with its defaults.

    The JAX package's opt-ins (``use_diag``, ``cluster_att``/``cluster_agg``
    and their ``_exact`` splits, ``use_rowwalk``, ``use_einsum_tiles``,
    ``tile_group > 1``, bf16 ``tile_dtype``) are not ported yet and raise
    ``NotImplementedError`` (ROADMAP.md §2)."""
    opt_ins = dict(use_diag=use_diag, use_rowwalk=use_rowwalk,
                   use_einsum_tiles=use_einsum_tiles,
                   tile_group=tile_group != 1,
                   tile_dtype=tile_dtype is not None,
                   cluster_att=cluster_att, cluster_att_exact=cluster_att_exact,
                   cluster_agg=cluster_agg, cluster_agg_exact=cluster_agg_exact)
    asked = [k for k, v in opt_ins.items() if v]
    if asked:
        raise NotImplementedError(
            f"build_hybrid: opt-in {', '.join(asked)} not ported yet "
            "(ROADMAP.md §2)")
    block = BLOCK
    if num_nodes_padded % block:
        raise ValueError(f"num_nodes_padded={num_nodes_padded} is not a "
                         f"multiple of {block}")
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float32)
    nb = num_nodes_padded // block
    tile = (receivers // block) * nb + (senders // block)
    uniq, inv, counts = np.unique(tile, return_inverse=True,
                                  return_counts=True)
    dense = counts[inv] >= min_block_edges

    bsr = None
    if dense.any():
        bsr = build_bsr(senders[dense], receivers[dense], weight[dense],
                        num_nodes_padded)

    cs, cr, cw = senders[~dense], receivers[~dense], weight[~dense]
    if len(cs) == 0:  # one weight-0 edge on the pad node keeps shapes whole
        cs = np.array([num_nodes_padded - 1], dtype=np.int64)
        cr = np.array([num_nodes_padded - 1], dtype=np.int64)
        cw = np.array([0.0], dtype=np.float32)

    order_f = np.argsort(cr, kind="stable")
    # transpose: roles swap; sort by the transpose's receiver (= sender)
    order_t = np.argsort(cs, kind="stable")
    inv_f = np.empty(len(order_f), dtype=np.int64)
    inv_f[order_f] = np.arange(len(order_f))
    t_edge_perm = inv_f[order_t]
    segmm = t_segmm = None
    if use_segmm:
        segmm = build_segmm(cs[order_f], cr[order_f], cw[order_f],
                            num_nodes_padded)
        t_segmm = build_segmm(cr[order_t], cs[order_t], cw[order_t],
                              num_nodes_padded)

    dyn_plan = None
    if semantics == "att_unit" and bsr is not None:
        # the grid-walk tile order: rows sorted with coverage fillers, whose
        # zero masks give zero attention tiles
        dyn_plan = build_dyn_plan(bsr.rows.numpy(), bsr.cols.numpy(),
                                  bsr.num_row_blocks)

    def i32(a):
        return torch.from_numpy(a.astype(np.int32))

    return HybridSpmm(
        bsr=bsr, senders=i32(cs[order_f]), receivers=i32(cr[order_f]),
        weights=torch.from_numpy(cw[order_f]),
        t_senders=i32(cr[order_t]), t_receivers=i32(cs[order_t]),
        t_weights=torch.from_numpy(cw[order_t]),
        t_edge_perm=i32(t_edge_perm), num_nodes=num_nodes_padded,
        semantics=semantics, segmm=segmm, t_segmm=t_segmm,
        dyn_plan=dyn_plan)


def _coo_apply(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """Forward straggler aggregation."""
    if h.segmm is not None:
        return segmm_spmm(h.segmm, x)
    return spmm_coo(h.weights, h.senders, h.receivers, x, h.num_nodes)


def _coo_apply_t(h: HybridSpmm, g: torch.Tensor) -> torch.Tensor:
    """Transpose straggler aggregation through the transpose edge list."""
    if h.t_segmm is not None:
        return segmm_spmm(h.t_segmm, g)
    return spmm_coo(h.t_weights, h.t_senders, h.t_receivers, g, h.num_nodes)


class _CooPart(torch.autograd.Function):
    """The straggler part alone (no dense tile)."""

    @staticmethod
    def forward(ctx, h, x):
        ctx.h = h
        return _coo_apply(h, x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, _coo_apply_t(ctx.h, g.contiguous())


class _FusedCore(torch.autograd.Function):
    """Stragglers, then the tiles accumulating on their output (K3 → K1);
    the backward runs the same chain on the transpose structures."""

    @staticmethod
    def forward(ctx, h, x):
        ctx.h = h
        return bsr_spmm_acc(h.bsr, x, _coo_apply(h, x))

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        h, g = ctx.h, g.contiguous()
        return None, bsr_spmm_acc(h.bsr.transpose, g, _coo_apply_t(h, g))


def hybrid_spmm(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """out = A·x, differentiable in ``x``: the straggler part alone when no
    tile is dense, else the fused core (K3, then K1 accumulating the tiles
    on its output).  A backward runs only for an ``x`` that needs a
    gradient (GCN's layer 0 aggregates the raw features, which do not)."""
    if h.bsr is None:
        return _CooPart.apply(h, x.contiguous())
    if h.bsr.transpose is None:
        raise NotImplementedError(
            "hybrid_spmm without a transpose BCSR runs K2 (bsr_spmm), the "
            "library spmm(operator=BsrMatrix) surface (ROADMAP.md §2)")
    return _FusedCore.apply(h, x.contiguous())
