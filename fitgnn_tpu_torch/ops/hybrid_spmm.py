"""Hybrid BCSR + straggler SpMM.

Community-reordered graphs put most edges inside dense E×E adjacency
tiles (E = ``block``: 128 by default, any multiple of 128 for the static
semantics), but a tail of cut edges would fill millions of nearly-empty
tiles.
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
(``ops/bsr_dynamic.py``) that the attention tiles walk, with the mask's
occupancy words above edge 128.

The JAX package's tile opt-ins, dispatched as its ``_hybrid_spmm_main``:

* ``use_diag``: the dense tiles on the block diagonal go to
  ``diag_blocks`` (nb, E, E) and the BCSR keeps the others (it may be
  ``None``).  With ``diag_r > 0`` the chain is K3 → K8 (``ops/diag_spmm.py``)
  → K1, every add through an ``init`` operand, and its backward the same
  chain on the transpose structures; otherwise the diagonal is added by a
  batched matmul, as the JAX package adds it by an XLA einsum.
* ``tile_group > 1`` and ``use_rowwalk``: the BCSR layouts of K9 and K10;
  the fused core then adds ``bsr_spmm`` (K9 or K10) to the stragglers, and
  a diagonal, if any, by the batched matmul.
* a BCSR built without its transpose (forward only) takes the straggler
  part plus ``bsr_spmm`` (K2 on the grid-walk layout).
* ``tile_dtype=torch.bfloat16``: the tiles and the diagonal blocks are
  stored in bf16 and every walk takes its bf16 form (``ops/bsr_spmm.py``,
  ``ops/diag_spmm.py``); the diagonal's batched matmul then runs in bf16,
  as the JAX package's einsum does.  ``torch.float16``,
  ``torch.float8_e4m3fn`` and ``torch.float8_e5m2`` store them in that
  type (cast as the JAX package casts, ``cast_tiles``).  The JAX
  package's kernels promote such tiles to f32 and leave ``x`` alone, so
  on the card the tiles and the diagonal blocks are held widened to f32
  (``bsr_spmm.card_tiles``) and every walk takes its f32 form; the
  diagonal's matmul and the static collapse's product promote them too,
  as XLA's do.  The collapse table keeps its type: the member summaries
  are rounded to it.
* bf16 activations (the conv stack's ``dtype=torch.bfloat16``): ``x`` and
  every chain's output are bf16, and each wrapper picks its form by
  ``x``'s type on every call (layer 0 of a GCN that is not pre-aggregated
  aggregates the f32 input, layer 1 bf16): K3 → K1 pass bf16 through K3a
  into K1a's ``init`` (K1bfa on bf16 tiles) with no f32 copy, forward and
  backward; the other forms take their widened route
  (``ops/kernels.py``).
* ``use_einsum_tiles``: the BCSR's einsum layout (plain PyTorch, as the
  JAX package's XLA einsum); like the row walk and the grouped layout, it
  takes no part in the diagonal chain, and K1's fused add becomes a
  separate one.  Under ``att_unit`` it has no dynamic-tile plan, as in the
  JAX package, so GAT's tiles take the einsum branch of ``ops/tile_gat.py``.

Under ``att_unit`` (GATConv) the same opt-ins build the JAX package's
attention operators: ``use_diag`` the diagonal blocks of presence weights
(in the tile type), which ``ops/tile_gat.py`` attends to by one batched
matmul, the BCSR the off-diagonal tiles; ``tile_group > 1`` the
group-padded tile list, over which the dynamic-tile plan is built (its
zero pads are empty masks); ``use_rowwalk`` (E = 128) and the einsum
layout no plan, so their tiles take ``ops/tile_gat.py``'s einsum branch.
Above 128 the plan's occupancy words (``words``, ``t_words``, ``live``)
are made of the BCSR's tiles, so they follow the off-diagonal and the
group-padded lists: a pad or filler tile has word 0.

The cluster collapse of the stragglers (``cluster_agg`` for the static
weights of GCN, SAGE and GIN, ``cluster_att`` for GAT's ``att_unit``), as
the JAX package builds it: the node space splits into contiguous clusters
of K nodes, and each straggler edge (u→v, w) reads the member mean of u's
cluster instead of x[u].  The (N, C) table ``cluster_count`` holds, per
receiver and sender cluster, the summed static weights (``cluster_agg``)
or the edge counts (``cluster_att``, read by ``ops/tile_gat.py``); the
``_exact`` splits keep the top-k straggler senders on the per-edge path.
The static term is plain PyTorch, as the JAX package's is XLA outside any
Pallas kernel: a member-masked reshape-sum and one dense (N, C) × (C, F)
product, added after the chains above on every layout.  It is approximate
by design (the reference's ``cluster_node`` idea applied per edge).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops.bsr_dynamic import DynPlan, build_dyn_plan
from fitgnn_tpu_torch.ops.bsr_spmm import (BLOCK, BsrMatrix, build_bsr,
                                           bsr_spmm, bsr_spmm_acc,
                                           card_tiles, cast_tiles,
                                           check_block, check_tile_dtype)
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
    diag_blocks: Optional[torch.Tensor] = None  # (NB, E, E) dense
                                       # block-diagonal tiles (use_diag),
                                       # in the BCSR's tile type (f32 on
                                       # the card for f16 and fp8)
    diag_r: int = 0                    # > 0: the diagonal runs through K8
                                       # (the TPU's blocks per grid step);
                                       # 0: a batched matmul
    # the cluster collapse (cluster_att / cluster_agg; None / 0 when off)
    cluster_count: Optional[torch.Tensor] = None  # (N, C) per receiver and
                                       # sender cluster: summed straggler
                                       # weights (static; f32, or the tile
                                       # type) or edge counts (att_unit;
                                       # bf16 while every count ≤ 256)
    cluster_scale: Optional[torch.Tensor] = None  # (C,) 1/|real members|
    cluster_member: Optional[torch.Tensor] = None  # (N,) 1.0 on real rows
    cluster_size: int = 0              # K, nodes a cluster (0: off)

    def __post_init__(self):
        self.diag_blocks = card_tiles(self.diag_blocks)

    @property
    def num_coo_edges(self) -> int:
        return self.senders.shape[0]

    def to(self, device) -> "HybridSpmm":
        return dataclass_to(self, device)


def build_hybrid(senders: np.ndarray, receivers: np.ndarray,
                 weight: np.ndarray, num_nodes_padded: int,
                 min_block_edges: int = 150,
                 block: int = BLOCK,
                 tile_dtype=None,
                 use_segmm: bool = False,
                 segmm_group=None,
                 use_diag: bool = False,
                 diag_r: Optional[int] = None,
                 use_rowwalk: bool = False,
                 tile_group: int = 1,
                 use_einsum_tiles: bool = False,
                 semantics: str = "gcn_norm",
                 cluster_att: int = 0,
                 cluster_att_exact: int = 0,
                 cluster_agg: int = 0,
                 cluster_agg_exact: int = 0,
                 real_nodes: Optional[int] = None,
                 build_dyn: bool = True) -> HybridSpmm:
    """Split edges by tile occupancy and build both structures (host-side),
    as the JAX package's ``build_hybrid`` does, with its ``block`` (the tile
    edge E, a multiple of 128: the tiles, the diagonal blocks and every
    layout at that edge), ``tile_dtype`` (``None`` or one of
    ``bsr_spmm.TILE_DTYPES``; another type raises ``ValueError``),
    ``use_diag`` / ``diag_r`` (``None`` → ``pick_run_length(nb)``),
    ``use_rowwalk`` (E = 128 only, as there), ``tile_group`` and
    ``use_einsum_tiles``.

    ``segmm_group`` (an int, ``"auto"`` or ``None``) is accepted and not
    read: in the JAX package it sets the TPU's chunk layout of K3's
    selectors (output blocks a selector chunk covers), which changes how
    the straggler sum is tiled and not what it computes.  The port's
    straggler CSR has no chunks, and its K3 gives the operator the JAX
    package builds with the same ``segmm_group``.

    ``cluster_att`` (``att_unit`` only) / ``cluster_agg`` (the static
    semantics): K, the nodes a cluster; the stragglers collapse onto the
    (N, C) table against their sender's cluster (see ``HybridSpmm``).
    ``cluster_att_exact`` / ``cluster_agg_exact``: the top-k straggler
    senders, ranked by straggler edge count (attention) or summed weight
    (static), keep the per-edge path.  ``real_nodes``: the rows that are
    not padding (the summaries' means leave the others out); defaults to
    ``num_nodes_padded``, which must be a multiple of both E and K.

    Under ``att_unit`` the dynamic-tile plan is built where the JAX
    package builds it: on a BCSR in neither the row-walk nor the einsum
    layout (the grid-walk list, or its group-padded form), unless
    ``build_dyn`` is False (the hierarchical layer's rank-local interior,
    as the JAX package's ``_stack_shard_hybrids`` builds it): then there is
    no plan, and GAT's tiles take ``ops/tile_gat.py``'s einsum branch."""
    check_tile_dtype(tile_dtype)
    check_block(block)
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
            diag_blocks = cast_tiles(torch.from_numpy(db), tile_dtype)
            diag_r_val = pick_run_length(nb) if diag_r is None else diag_r

    bsr = None
    tiled = dense & ~on_diag
    if tiled.any():
        bsr = build_bsr(senders[tiled], receivers[tiled], weight[tiled],
                        num_nodes_padded, block, tile_dtype=tile_dtype,
                        rowwalk=use_rowwalk,
                        group=tile_group, einsum=use_einsum_tiles)

    cs, cr, cw = senders[~dense], receivers[~dense], weight[~dense]
    cluster = {}
    if cluster_att and cluster_agg:
        raise ValueError("cluster_att and cluster_agg are mutually "
                         "exclusive (attention vs static semantics)")
    if cluster_att or cluster_agg:
        cluster, keep = _collapse(cs, cr, cw, num_nodes_padded, semantics,
                                  cluster_att, cluster_att_exact,
                                  cluster_agg, cluster_agg_exact,
                                  tile_dtype, real_nodes)
        cs, cr, cw = cs[keep], cr[keep], cw[keep]
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
    if (build_dyn and semantics == "att_unit" and bsr is not None
            and not bsr.rowwalk and not bsr.einsum):
        # the grid-walk tile order: rows sorted with coverage fillers (and
        # group pads), whose zero masks give zero attention tiles (the row
        # walk and einsum layouts have none); above 128 the mask's
        # occupancy words, which cover every non-zero of the attention
        # tiles where(mask, exp(.), 0)
        dyn_plan = build_dyn_plan(bsr.rows.numpy(), bsr.cols.numpy(),
                                  bsr.num_row_blocks, words=bsr.quad_bits,
                                  block=bsr.block)

    def i32(a):
        return torch.from_numpy(a.astype(np.int32))

    return HybridSpmm(
        bsr=bsr, senders=i32(cs[order_f]), receivers=i32(cr[order_f]),
        weights=torch.from_numpy(cw[order_f]),
        t_senders=i32(cr[order_t]), t_receivers=i32(cs[order_t]),
        t_weights=torch.from_numpy(cw[order_t]),
        t_edge_perm=i32(t_edge_perm), num_nodes=num_nodes_padded,
        semantics=semantics, segmm=segmm, t_segmm=t_segmm,
        dyn_plan=dyn_plan, diag_blocks=diag_blocks, diag_r=diag_r_val,
        **cluster)


def _collapse(cs, cr, cw, n: int, semantics: str, cluster_att: int,
              cluster_att_exact: int, cluster_agg: int,
              cluster_agg_exact: int, tile_dtype,
              real_nodes: Optional[int]) -> tuple:
    """The cluster collapse of the straggler lists ``(cs, cr, cw)``, as the
    JAX package's ``build_hybrid`` makes it: the ``HybridSpmm`` fields of
    the collapse, and the mask of the straggler edges that keep the
    per-edge path (the ``_exact`` senders' real edges)."""
    if cluster_att and semantics != "att_unit":
        raise ValueError("cluster_att is an attention factorization "
                         "(semantics='att_unit' only)")
    if cluster_agg and semantics == "att_unit":
        raise ValueError("cluster_agg is for static-weight semantics; "
                         "use cluster_att for att_unit")
    k_size = cluster_att or cluster_agg
    exact_k = cluster_att_exact if cluster_att else cluster_agg_exact
    if n % k_size:
        raise ValueError(f"cluster size {k_size} must divide the "
                         f"padded node count {n}")
    c = n // k_size
    real = cw > 0                          # padding edges never count
    keep = np.zeros(len(cs), dtype=bool)
    if exact_k:
        # senders ranked by the straggler mass of their edges: the edge
        # count under attention, the summed static weight otherwise
        if cluster_att:
            deg = np.bincount(cs[real], minlength=n).astype(np.float64)
        else:
            deg = np.bincount(cs[real], weights=cw[real].astype(np.float64),
                              minlength=n)
        k = min(int(exact_k), int((deg > 0).sum()))
        if k:
            top = np.argpartition(deg, -k)[-k:]
            is_top = np.zeros(n, dtype=bool)
            is_top[top[deg[top] > 0]] = True
            keep = is_top[cs] & real
    collapse = real & ~keep
    cc = np.zeros((n, c), dtype=np.float32)
    np.add.at(cc, (cr[collapse], cs[collapse] // k_size),
              1.0 if cluster_att else cw[collapse])
    if cluster_att:
        # integer counts up to 256 are exact in bf16
        cdtype = torch.bfloat16 if cc.max() <= 256 else torch.float32
    else:
        # summed weights, stored as the tiles are
        cdtype = tile_dtype if tile_dtype is not None else torch.float32
    nr = n if real_nodes is None else int(real_nodes)
    member = (np.arange(n) < nr).astype(np.float32)
    counts = member.reshape(c, k_size).sum(axis=1)
    return dict(cluster_count=cast_tiles(torch.from_numpy(cc), cdtype),
                cluster_scale=torch.from_numpy(
                    (1.0 / np.maximum(counts, 1.0)).astype(np.float32)),
                cluster_member=torch.from_numpy(member),
                cluster_size=k_size), keep


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
    K3 + K9/K10/the einsum on their layouts); the backward runs the same
    chain on the transpose structures."""

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
    """diag(A)·x as one batched matmul over the (nb, E, F) views (the
    JAX package's XLA einsum branch: on bf16 blocks x is cast to bf16 and
    the product comes out in bf16; blocks of any other type and x are
    promoted to at least f32, so bf16 x on f32 blocks gives the f32
    product rounded to bf16 once); autograd gives its transpose."""
    nb, b, _ = blocks.shape
    if blocks.dtype != torch.bfloat16:
        blocks = blocks.to(torch.promote_types(x.dtype, torch.float32))
    xb = x.to(blocks.dtype).reshape(nb, b, -1)
    return torch.bmm(blocks, xb).reshape(x.shape).to(x.dtype)


def _cluster_static_term(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """The collapsed stragglers under static weights, as the JAX package's
    ``_cluster_static_term``: each cluster's member sum in f32 (a K-long
    sum in bf16 would lose about 3 digits), times ``cluster_scale``,
    rounded to the table's type as the JAX package casts
    (``cast_tiles``), then ``table @ summaries`` with both widened to f32
    (the JAX package's ``preferred_element_type=f32``; the products of two
    bf16, f16 or fp8 values are exact in f32).  Autograd gives the
    backward: the transposed product and a broadcast."""
    k_size = h.cluster_size
    table = h.cluster_count
    c = table.shape[1]
    member = h.cluster_member.to(x.dtype)        # 0/1: exact in any type
    sums = (x * member[:, None]).reshape(c, k_size, x.shape[-1]).sum(
        1, dtype=torch.float32)
    summaries = cast_tiles(sums * h.cluster_scale[:, None], table.dtype)
    return torch.matmul(table.float(), summaries.float()).to(x.dtype)


def hybrid_spmm(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """``_hybrid_spmm_main``, plus the collapsed stragglers' term for every
    semantics but ``att_unit`` (whose table ``ops/tile_gat.py`` reads)."""
    out = _hybrid_spmm_main(h, x)
    if h.cluster_size and h.semantics != "att_unit":
        out = out + _cluster_static_term(h, x).to(out.dtype)
    return out


def _hybrid_spmm_main(h: HybridSpmm, x: torch.Tensor) -> torch.Tensor:
    """out = A·x, differentiable in ``x``, dispatched condition for
    condition as the JAX package's ``_hybrid_spmm_main``: the diagonal chain
    (K3 → K8 → K1) when the operator has diagonal blocks with ``diag_r >
    0`` and its BCSR (if any) has a transpose on the grid-walk layout;
    else the fused core (K3 → K1, or K3 + K9/K10/the einsum), or, without
    a transpose BCSR, the straggler part plus ``bsr_spmm`` (K2/K9/K10/the
    einsum); then the diagonal, if any, by a batched matmul.  A backward
    runs only for an ``x`` that needs a gradient (GCN's layer 0 aggregates
    the raw features, which do not)."""
    x = x.contiguous()
    b = h.bsr
    if (h.diag_blocks is not None and h.diag_r > 0
            and (b is None or b.transpose is not None)
            and not (b is not None and (b.rowwalk or b.einsum
                                        or b.group > 1))):
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
