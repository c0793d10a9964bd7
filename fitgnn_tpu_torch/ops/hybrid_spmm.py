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

The JAX package's tile opt-ins, dispatched as its ``_hybrid_spmm_main``:

* ``use_diag``: the dense tiles on the block diagonal go to
  ``diag_blocks`` (nb, 128, 128) and the BCSR keeps the others (it may be
  ``None``).  With ``diag_r > 0`` the chain is K3 → K8 (``ops/diag_spmm.py``)
  → K1, every add through an ``init`` operand, and its backward the same
  chain on the transpose structures; otherwise the diagonal is added by a
  batched matmul, as the JAX package adds it by an XLA einsum.
* ``tile_group > 1`` and ``use_rowwalk``: the BCSR layouts of K9 and K10;
  the fused core then adds ``bsr_spmm`` (K9 or K10) to the stragglers, and
  a diagonal, if any, by the batched matmul.
* a BCSR built without its transpose (forward only) takes the straggler
  part plus ``bsr_spmm`` (K2 on the grid-walk layout).

``att_unit`` (GATConv) refuses ``use_diag``, ``use_rowwalk`` and
``tile_group > 1``: its tile attention walks the grid-walk tiles only.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops.bsr_dynamic import DynPlan, build_dyn_plan
from fitgnn_tpu_torch.ops.bsr_spmm import (BLOCK, BsrMatrix, build_bsr,
                                           bsr_spmm, bsr_spmm_acc)
from fitgnn_tpu_torch.ops.coo_segmm import SegCsr, build_segmm, segmm_spmm
from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, pick_run_length
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
    diag_blocks: Optional[torch.Tensor] = None  # (NB, 128, 128) dense
                                       # block-diagonal tiles (use_diag)
    diag_r: int = 0                    # > 0: the diagonal runs through K8
                                       # (the TPU's blocks per grid step);
                                       # 0: a batched matmul

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
                 diag_r: Optional[int] = None,
                 use_rowwalk: bool = False,
                 tile_group: int = 1,
                 use_einsum_tiles: bool = False,
                 semantics: str = "gcn_norm",
                 cluster_att: int = 0,
                 cluster_att_exact: int = 0,
                 cluster_agg: int = 0,
                 cluster_agg_exact: int = 0) -> HybridSpmm:
    """Split edges by tile occupancy and build both structures (host-side),
    as the JAX package's ``build_hybrid`` does, with its ``use_diag`` /
    ``diag_r`` (``None`` → ``pick_run_length(nb)``), ``use_rowwalk`` and
    ``tile_group``.

    ``use_einsum_tiles``, bf16 ``tile_dtype`` and ``cluster_att`` /
    ``cluster_agg`` with their ``_exact`` splits are not ported yet and
    raise ``NotImplementedError`` (ROADMAP.md §1 item 2); so do
    ``use_diag``, ``use_rowwalk`` and ``tile_group > 1`` under
    ``att_unit`` (ROADMAP.md §1 item 3)."""
    opt_ins = dict(use_einsum_tiles=use_einsum_tiles,
                   tile_dtype=tile_dtype is not None,
                   cluster_att=cluster_att, cluster_att_exact=cluster_att_exact,
                   cluster_agg=cluster_agg, cluster_agg_exact=cluster_agg_exact)
    asked = [k for k, v in opt_ins.items() if v]
    if asked:
        raise NotImplementedError(
            f"build_hybrid: opt-in {', '.join(asked)} not ported yet "
            "(ROADMAP.md §1 item 2)")
    if semantics == "att_unit" and (use_diag or use_rowwalk
                                    or tile_group != 1):
        raise NotImplementedError(
            "build_hybrid: use_diag, use_rowwalk and tile_group > 1 under "
            "att_unit (GATConv's tile attention) are not ported yet "
            "(ROADMAP.md §1 item 3)")
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

    diag_blocks = None
    diag_r_val = 0
    on_diag = np.zeros_like(dense)
    if use_diag:
        on_diag = dense & (receivers // block == senders // block)
        if on_diag.any():
            db = np.zeros((nb, block, block), dtype=np.float32)
            np.add.at(db, (receivers[on_diag] // block,
                           receivers[on_diag] % block,
                           senders[on_diag] % block), weight[on_diag])
            diag_blocks = torch.from_numpy(db)
            diag_r_val = pick_run_length(nb) if diag_r is None else diag_r

    bsr = None
    tiled = dense & ~on_diag
    if tiled.any():
        bsr = build_bsr(senders[tiled], receivers[tiled], weight[tiled],
                        num_nodes_padded, rowwalk=use_rowwalk,
                        group=tile_group)

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
        dyn_plan=dyn_plan, diag_blocks=diag_blocks, diag_r=diag_r_val)


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
    """Stragglers, then the tiles accumulating on their output (K3 → K1, or
    K3 + K9/K10 on their layouts); the backward runs the same chain on the
    transpose structures."""

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


def _diag_chain(h: HybridSpmm, x: torch.Tensor,
                transpose: bool) -> torch.Tensor:
    """Stragglers → K8 → K1, every add through an ``init`` operand; with
    ``transpose`` the same chain on the transpose structures."""
    out = _coo_apply_t(h, x) if transpose else _coo_apply(h, x)
    out = diag_spmm(h.diag_blocks, x, h.diag_r, transpose=transpose,
                    init=out)
    if h.bsr is not None:
        out = bsr_spmm_acc(h.bsr.transpose if transpose else h.bsr, x, out)
    return out


class _FusedCoreDiag(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, x):
        ctx.h = h
        return _diag_chain(h, x, transpose=False)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, _diag_chain(ctx.h, g.contiguous(), transpose=True)


def _diag_bmm(blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """diag(A)·x as one batched matmul over the (nb, 128, F) views (the
    JAX package's XLA einsum branch); autograd gives its transpose."""
    nb, b, _ = blocks.shape
    return torch.bmm(blocks.to(x.dtype), x.reshape(nb, b, -1)).reshape(
        x.shape)


def hybrid_spmm(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """out = A·x, differentiable in ``x``, dispatched condition for
    condition as the JAX package's ``_hybrid_spmm_main``: the diagonal chain
    (K3 → K8 → K1) when the operator has diagonal blocks with ``diag_r >
    0`` and its BCSR (if any) has a transpose on the grid-walk layout;
    else the fused core (K3 → K1, or K3 + K9/K10), or, without a transpose
    BCSR, the straggler part plus ``bsr_spmm`` (K2/K9/K10); then the
    diagonal, if any, by a batched matmul.  A backward runs only for an
    ``x`` that needs a gradient (GCN's layer 0 aggregates the raw features,
    which do not)."""
    x = x.contiguous()
    b = h.bsr
    if (h.diag_blocks is not None and h.diag_r > 0
            and (b is None or b.transpose is not None)
            and not (b is not None and (b.rowwalk or b.group > 1))):
        return _FusedCoreDiag.apply(h, x)
    if b is not None and b.transpose is not None:
        out = _FusedCore.apply(h, x)
    else:
        out = _CooPart.apply(h, x)
        if b is not None:
            out = out + bsr_spmm(b, x)
    if h.diag_blocks is not None:
        out = out + _diag_bmm(h.diag_blocks, x)
    return out
