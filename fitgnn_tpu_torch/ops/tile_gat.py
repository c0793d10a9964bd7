"""Tile-dense GAT attention on the hybrid BCSR/straggler operator.

On a community-reordered graph most edges live in dense 128×128 adjacency
tiles, where single-head GAT attention has a dense form with no per-edge
tensors: tile scores ``E_t[i,j] = LeakyReLU(s_dst[row_i] + s_src[col_j])``
masked by the static adjacency tile, and the weighted aggregation over
them.  Only the straggler edges keep the per-edge path.

This is the JAX package's ``tile_gat_attention`` with the environment
switches it reads, read here when the function is called (a switch is on
only at exactly ``"1"``):

* default: the global-bound stabilizer ``m̂[r] = max(0, s_dst[r] +
  max_all s_src)`` (any per-row upper bound stabilizes a shift-invariant
  softmax; the max runs over every padded row and is detached where JAX
  has ``stop_gradient``), the two-stage tiles (``tiles_two_stage``:
  materialised ``pe``, then K4, ``ops/bsr_dynamic.py``), sender scores from
  the gathered message rows when ``att_src`` is given, and the softmax
  denominator riding the straggler numerator scatter as an extra column,
  or K3w (``ops/coo_segmm.py``) for widths ≤ ``FITGNN_GAT_SEGMM_MAXF``
  (default 64);
* ``FITGNN_GAT_FUSED_TILES=1``: the fused tile attention (K7,
  ``ops/att_bsr.py``) where the operator has tiles and a dynamic plan and
  F ≤ 512;
* ``FITGNN_GAT_GLOBAL_MAX=0``: the exact per-receiver max, its tile part
  from K7's ``att_rowmax`` when fused, else from the materialised scores;
* ``FITGNN_GAT_SEGMM_DEN=1``: the straggler numerator and denominator from
  K6 at any width, with sender scores gathered from ``score_src``;
* the diagnostic switches, plain PyTorch as the JAX package's are plain
  XLA (each of its ``custom_vjp`` a ``torch.autograd.Function``):
  ``FITGNN_GAT_SORTED_SRC=1`` gathers the straggler sender scores with a
  backward that sums over the sorted transpose list
  (``_GatherSenders``), ``FITGNN_GAT_SORTED_NUM=1`` the numerator with
  both backward sums sorted (``_WeightedSpmmSorted``), and
  ``FITGNN_GAT_FUSED_BWD=1`` the straggler numerator and denominator in
  one augmented sum with a closed-form backward
  (``_StragglerAttentionFused``; its ``dh`` over the sorted transpose list
  under ``FITGNN_GAT_FUSED_SORTED_DH=1``).  Each is taken under the JAX
  package's predicates (``FUSED_BWD`` needs the global max, ``att_src``,
  no K3w or K6 and neither of the other three switches on).

The tiles may have any edge E that is a multiple of 128
(``build_hybrid(block=E, semantics="att_unit")``): the two-stage path, the
exact max and the einsum branch take E from the tiles' shape, K4, K4ᵀ and
K5 walk E-wide tiles as 128-wide quadrants, and so does the fused path
(K7rm, K7f, K7bt's ``dx`` and the score pass, ``ops/att_bsr.py``), as the
JAX package hands ``bsr.block`` to its fused kernels.  The tile opt-ins of
``build_hybrid`` reach this module as the JAX package's do: the
group-padded tile list (``tile_group > 1``) with its plan, whose zero pads
are empty masks; the row-walk layout (``use_rowwalk``) without a plan, so
its tiles take the einsum branch; and the diagonal blocks (``use_diag``),
attended to by one batched matmul over contiguous slabs after the
stragglers (masked before the exp; the exact max folds in their row
maxima), while the tiles, two-stage or fused, hold the off-diagonal
blocks.  The hierarchical layer (``parallel/hierarchical.py``) folds
edges this operator does not see into the same softmax: ``partials``
returns ``(num, den, m)`` before the normalization (and keeps the
``FUSED_BWD`` branch off, as the JAX package does), ``src_score_bound``
replaces ``max(score_src)`` in the global-max bound and ``extra_rowmax``
is folded into the exact max.

With the cluster collapse (``build_hybrid(cluster_att=K)``) each collapsed
straggler edge attends to its sender's cluster-summary row: the summary's
score is the member mean of ``score_src`` (means commute with the linear
score projection), and its message the member mean of ``h``.  One dense
(N, C) score block, masked by the count table before the exp and weighted
by the counts, and one (N, C) × (C, F) product add to the numerator and
the denominator, after the stragglers and the diagonal and before the
tiles, under every switch; the exact max folds in the summary rows' max.
This is plain PyTorch, as the JAX package's is XLA.  The tiles may be bf16,
f16 or fp8 (``tile_dtype``): they are the 0/1 mask, so the scores and
``pe`` stay f32 and only the kernels' tile loads change (the mask is read
through ``tile_values``, which widens fp8, whose comparisons not every
device has).  The einsum
layout has no dynamic-tile plan, so its tiles take the JAX package's XLA
branch: a batched matmul of ``pe`` and the gathered slabs and a sum over
block rows, in plain PyTorch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from fitgnn_tpu_torch.ops.att_bsr import MAX_F, att_rowmax, att_rowmax_plain, \
    att_tiles
from fitgnn_tpu_torch.ops.bsr_dynamic import bsr_spmm_dyn
from fitgnn_tpu_torch.ops.bsr_spmm import tile_values
from fitgnn_tpu_torch.ops.coo_segmm import segmm_weighted_spmm, \
    segmm_weighted_spmm_den
from fitgnn_tpu_torch.ops.segment import segment_sum, take_rows

_NEG = -1e30  # "minus infinity" that survives exp/where without NaNs


@dataclasses.dataclass(frozen=True)
class Switches:
    """The JAX package's ``tile_gat`` switches, with its defaults."""

    fused_tiles: bool = False       # FITGNN_GAT_FUSED_TILES
    global_max: bool = True         # FITGNN_GAT_GLOBAL_MAX
    segmm_den: bool = False         # FITGNN_GAT_SEGMM_DEN
    segmm_max_f: int = 64           # FITGNN_GAT_SEGMM_MAXF
    fused_bwd: bool = False         # FITGNN_GAT_FUSED_BWD
    fused_sorted_dh: bool = False   # FITGNN_GAT_FUSED_SORTED_DH
    sorted_src: bool = False        # FITGNN_GAT_SORTED_SRC
    sorted_num: bool = False        # FITGNN_GAT_SORTED_NUM


def switches() -> Switches:
    """Read the switches from the environment as the JAX package reads
    them."""
    def on(name: str, default: str = "0") -> bool:
        return os.environ.get(name, default) == "1"

    return Switches(fused_tiles=on("FITGNN_GAT_FUSED_TILES"),
                    global_max=on("FITGNN_GAT_GLOBAL_MAX", "1"),
                    segmm_den=on("FITGNN_GAT_SEGMM_DEN"),
                    segmm_max_f=int(os.environ.get("FITGNN_GAT_SEGMM_MAXF",
                                                   "64")),
                    fused_bwd=on("FITGNN_GAT_FUSED_BWD"),
                    fused_sorted_dh=on("FITGNN_GAT_FUSED_SORTED_DH"),
                    sorted_src=on("FITGNN_GAT_SORTED_SRC"),
                    sorted_num=on("FITGNN_GAT_SORTED_NUM"))


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


# ---- the diagnostic switches' straggler primitives --------------------------
# Both straggler lists are sorted (the forward by receiver, the transpose
# by sender) and ``t_edge_perm`` maps per-edge data between the two orders,
# so each backward below sums over a sorted list.

class _GatherSenders(torch.autograd.Function):
    """``v[senders]`` whose backward sums over the sorted transpose list
    (the JAX package's ``_gather_senders``)."""

    @staticmethod
    def forward(ctx, aux, v):
        ctx.aux = aux
        return take_rows(v, aux.senders)

    @staticmethod
    def backward(ctx, g):
        aux = ctx.aux
        return None, segment_sum(take_rows(g, aux.t_edge_perm),
                                 aux.t_receivers, aux.num_nodes)


class _WeightedSpmmSorted(torch.autograd.Function):
    """``out[r] = Σ_e w[e]·x[s_e]`` with both backward sums sorted: ``dx``
    over the transpose list, ``dw`` a row-wise dot of sorted gathers (the
    JAX package's ``_weighted_spmm_sorted``); the gathered rows are saved
    for the backward."""

    @staticmethod
    def forward(ctx, aux, w, x):
        y = take_rows(x, aux.senders)
        ctx.aux = aux
        ctx.save_for_backward(w, y)
        return segment_sum(y * w[:, None].to(x.dtype), aux.receivers,
                           aux.num_nodes)

    @staticmethod
    def backward(ctx, g):
        aux = ctx.aux
        w, y = ctx.saved_tensors
        wt = take_rows(w, aux.t_edge_perm)
        gt = take_rows(g, aux.t_senders)
        dx = segment_sum(gt * wt[:, None].to(g.dtype), aux.t_receivers,
                         aux.num_nodes)
        gr = take_rows(g, aux.receivers)
        dw = (gr.float() * y.float()).sum(-1).to(w.dtype)
        return None, dw, dx


def _strag_core(aux, sm, h, score_dst, a_src, maxs, slope: float):
    """One augmented row sum ``Σ_e pes·[y | 1 | lp·y | lp]`` over the
    stragglers: ``num``, ``den`` and the residuals ``num'``, ``den'`` of
    the closed-form backward (``lp`` = LeakyReLU'), with the sender scores
    from the gathered rows and the global bound ``maxs``."""
    f = h.shape[-1]
    y = take_rows(h, aux.senders)                          # (E, F)
    ssrc = y.float() @ a_src.float()
    sdst = take_rows(score_dst.float(), aux.receivers)
    pre = ssrc + sdst
    es = torch.where(pre >= 0, pre, slope * pre)
    m_e = (sdst + maxs).clamp_min(0.0)                     # a constant bound
    pes = torch.exp(torch.where(sm, es, _NEG) - m_e) * sm
    lp = torch.where(pre >= 0, 1.0, slope) * sm            # LeakyReLU'
    pc = pes[:, None].to(h.dtype)
    plc = (pes * lp)[:, None].to(h.dtype)
    s = segment_sum(torch.cat([y * pc, pc, y * plc, plc], dim=1),
                    aux.receivers, aux.num_nodes)          # (N, 2F+2)
    return (s[:, :f], s[:, f].float(), s[:, f + 1:2 * f + 1],
            s[:, 2 * f + 1].float(), y, pes, lp)


class _StragglerAttentionFused(torch.autograd.Function):
    """The stragglers' ``(num, den)`` with no scalar segment sum in the
    backward (the JAX package's ``_straggler_attention_fused``):
    ``dL/dsdst[r] = ⟨num'[r], dnum[r]⟩ + den'[r]·dden[r]``, node-local;
    ``dh`` one row gather and one row sum, over the senders or, with
    ``sorted_dh``, over the sorted transpose list; ``da_src`` one
    multiply-reduce over the saved rows."""

    @staticmethod
    def forward(ctx, aux, sm, h, score_dst, a_src, maxs, slope, sorted_dh):
        num, den, nump, denp, y, pes, lp = _strag_core(
            aux, sm, h, score_dst, a_src, maxs, slope)
        ctx.aux, ctx.sorted_dh = aux, sorted_dh
        ctx.dtypes = (h.dtype, score_dst.dtype)
        ctx.save_for_backward(y, pes, lp, nump, denp, a_src)
        return num, den

    @staticmethod
    def backward(ctx, dnum, dden):
        aux = ctx.aux
        hdt, sdt = ctx.dtypes
        y, pes, lp, nump, denp, a_src = ctx.saved_tensors
        f = y.shape[-1]
        gaug = torch.cat([dnum, dden[:, None].to(dnum.dtype)], dim=1)
        g_e = take_rows(gaug, aux.receivers)                # (E, F+1)
        t_e = (g_e[:, :f].float() * y.float()).sum(-1) + g_e[:, f].float()
        dpre = pes * lp * t_e                               # dL/dpre
        dsdst = ((nump.float() * dnum.float()).sum(-1)
                 + denp * dden.float())                     # node-local
        da_src = dpre @ y.float()
        dy = (pes[:, None].to(hdt) * g_e[:, :f].to(hdt)
              + dpre[:, None].to(hdt) * a_src.to(hdt)[None, :])
        if ctx.sorted_dh:
            dh = segment_sum(take_rows(dy, aux.t_edge_perm), aux.t_receivers,
                             aux.num_nodes)
        else:
            dh = segment_sum(dy, aux.senders, aux.num_nodes)
        return (None, None, dh, dsdst.to(sdt), da_src.to(a_src.dtype), None,
                None, None)


def tile_gat_attention(aux, score_src: torch.Tensor, score_dst: torch.Tensor,
                       h: torch.Tensor, negative_slope: float,
                       att_src: Optional[torch.Tensor] = None,
                       partials: bool = False, src_score_bound=None,
                       extra_rowmax=None) -> torch.Tensor:
    """Single-head GAT aggregation through ``aux`` (a ``HybridSpmm`` with
    ``semantics='att_unit'``: presence tiles plus straggler lists).

    ``score_src``/``score_dst``: (N,) per-node attention projections;
    ``h``: (N, F) messages; ``att_src``: the (F,) attention vector, which
    derives the straggler sender scores from the gathered message rows.
    Returns (N, F).  The branches are the JAX package's, predicate for
    predicate.

    ``partials=True`` returns ``(num, den, m)`` before the normalization,
    so that a caller can add edges this operator does not see (the
    hierarchical layer's halo and summary edges) to the same softmax.  The
    stabilizer must then bound those edges' scores too:
    ``src_score_bound`` replaces ``max(score_src)`` in the global-max bound
    (the caller passes the max over every sender table), and
    ``extra_rowmax`` (N,) is folded into the exact max."""
    sw = switches()
    n = aux.num_nodes
    f = h.shape[-1]
    senders, receivers = aux.senders, aux.receivers

    # ---- straggler per-edge scores (receiver-sorted lists) ----------------
    sm = aux.weights > 0
    sorted_bwd = aux.t_edge_perm is not None
    use_segmm_den = sw.segmm_den and aux.segmm is not None
    use_segmm = (aux.segmm is not None and f <= sw.segmm_max_f
                 and not use_segmm_den)
    if (sw.fused_bwd and sw.global_max and att_src is not None and sorted_bwd
            and not use_segmm and not use_segmm_den and not sw.sorted_num
            and not sw.sorted_src and not sw.fused_tiles and not partials):
        maxs = score_src.float().max().detach()
        m = (score_dst.float() + maxs).clamp_min(0.0).detach()
        num, den = _StragglerAttentionFused.apply(
            aux, sm, h, score_dst, att_src, maxs, float(negative_slope),
            sw.fused_sorted_dh)
        return _finish_tiles(aux, score_src, score_dst, h, negative_slope, m,
                             num, den, fused=False)
    y = None
    if (att_src is not None and not use_segmm and not use_segmm_den
            and not (sorted_bwd and sw.sorted_num)):
        y = take_rows(h, senders)                   # reused by the numerator
        ssrc_e = y.float() @ att_src.float()
    elif sorted_bwd and sw.sorted_src:
        ssrc_e = _GatherSenders.apply(aux, score_src)
    else:
        ssrc_e = take_rows(score_src, senders)
    sdst_e = take_rows(score_dst, receivers)
    es = torch.where(sm, _leaky(ssrc_e + sdst_e, negative_slope), _NEG)

    fused = (aux.bsr is not None and aux.dyn_plan is not None and f <= MAX_F
             and sw.fused_tiles)
    if sw.global_max:
        # LeakyReLU(sdst[r] + ssrc[s]) ≤ max(0, sdst[r] + max ssrc), one
        # reduction over all rows
        maxs = (score_src.float().max() if src_score_bound is None else
                torch.as_tensor(src_score_bound, dtype=torch.float32,
                                device=score_src.device)).detach()
        m = (score_dst.float() + maxs).clamp_min(0.0).detach()
        m_e = (sdst_e.float() + maxs).clamp_min(0.0).detach()
    else:
        m = _exact_max(aux, es, score_src, score_dst, negative_slope, fused,
                       extra_rowmax)
        m_e = take_rows(m, receivers)

    # ---- straggler numerator and denominator ------------------------------
    pes = torch.exp(es - m_e) * sm
    if use_segmm_den:
        num, den = segmm_weighted_spmm_den(aux.segmm, aux.t_segmm, receivers,
                                           aux.t_edge_perm, pes, h)
    elif use_segmm:
        num = segmm_weighted_spmm(aux.segmm, aux.t_segmm, senders, receivers,
                                  aux.t_edge_perm, pes, h)
        den = segment_sum(pes, receivers, n)
    elif sorted_bwd and sw.sorted_num:
        num = _WeightedSpmmSorted.apply(aux, pes, h)
        den = segment_sum(pes, receivers, n)
    else:
        if y is None:
            y = take_rows(h, senders)
        # the denominator rides the numerator scatter as an extra column
        pcol = pes[:, None].to(h.dtype)
        num_aug = segment_sum(torch.cat([y * pcol, pcol], dim=1), receivers,
                              n)
        num = num_aug[:, :f]
        den = num_aug[:, f].float()
    return _finish_tiles(aux, score_src, score_dst, h, negative_slope, m,
                         num, den, fused=fused, partials=partials)


def _finish_tiles(aux, score_src, score_dst, h, slope: float, m, num, den,
                  fused: bool, partials: bool = False):
    """Add the diagonal blocks', the cluster summaries' and the tiles'
    contributions to the stragglers' ``(num, den)``, in the JAX package's
    order, and normalize (with ``partials``, return ``(num, den, m)``
    instead)."""
    n = aux.num_nodes
    f = h.shape[-1]
    if aux.diag_blocks is not None:
        # the diagonal blocks' out rows are their block rows: one batched
        # matmul over contiguous slabs, no gather and no scatter
        b = aux.diag_blocks.shape[-1]
        nb = n // b
        e_d = _diag_scores(aux, score_src, score_dst, slope)
        pe_d = torch.where(tile_values(aux.diag_blocks) > 0, torch.exp(
            e_d - m.reshape(nb, b)[:, :, None]), 0.0)
        num = num + torch.bmm(pe_d.to(h.dtype), h.reshape(nb, b, f)).reshape(
            n, f).to(num.dtype)
        den = den + pe_d.sum(2).reshape(n)

    if aux.cluster_count is not None:
        # duplicate edges from one cluster share the summary's score, so the
        # count multiplies the numerator.  The global-max bound needs no
        # fold: the summary score is a mean of member scores, at most
        # max(score_src)
        cnt = aux.cluster_count                              # (N, C)
        c = n // aux.cluster_size
        member = aux.cluster_member.float()
        # masked BEFORE the exp, as the tiles are: every exponent stays ≤ 0
        e_c = _cluster_scores(aux, score_src, score_dst, slope)
        pe_c = torch.exp(e_c - m[:, None]) * cnt.float()
        hs = ((h.float() * member[:, None]).reshape(c, aux.cluster_size, f)
              .sum(1) * aux.cluster_scale[:, None]).to(h.dtype)  # (C, F)
        num = num + (pe_c.to(h.dtype) @ hs).to(num.dtype)
        den = den + pe_c.sum(1)

    bsr = aux.bsr
    if bsr is not None:
        tiles = att_tiles if fused else tiles_two_stage
        num_t, den_t = tiles(slope, bsr.rows, bsr.cols, aux.dyn_plan,
                             bsr.blocks, score_src.float(), score_dst.float(),
                             m, h)
        num = num + num_t.to(num.dtype)
        den = den + den_t
    if partials:
        return num, den, m
    den = den.clamp_min(1e-16).to(h.dtype)
    return num / den[:, None]


def _exact_max(aux, es, score_src, score_dst, slope: float,
               fused: bool, extra_rowmax=None) -> torch.Tensor:
    """The exact per-receiver max over straggler, tile, diagonal-block and
    cluster-summary scores and ``extra_rowmax``, detached; −1e30 where a
    row has no edge (never 0: a row whose every score sits below −88 would
    underflow its denominator to 0)."""
    bsr = aux.bsr
    with torch.no_grad():
        m = torch.full((aux.num_nodes,), _NEG, dtype=torch.float32,
                       device=es.device)
        m = m.scatter_reduce(0, aux.receivers.long(), es.float(), "amax",
                             include_self=True)
        if bsr is not None:
            # the fused branch's K7rm, or the same max from the materialised
            # tile scores (its plain version, the JAX package's XLA branch)
            rowmax = att_rowmax if fused else att_rowmax_plain
            m = torch.maximum(m, rowmax(bsr.rows, bsr.cols, aux.dyn_plan,
                                        bsr.blocks, score_src.float(),
                                        score_dst.float(), slope))
        if aux.diag_blocks is not None:
            # the diagonal blocks carry in-edges too: an interior node whose
            # every edge is diagonal would otherwise exponentiate against
            # −1e30
            m = torch.maximum(m, _diag_scores(
                aux, score_src, score_dst, slope).amax(2).reshape(-1))
        if aux.cluster_count is not None:
            # the summary rows carry in-edges too: a row whose every in-edge
            # collapsed would otherwise exponentiate against −1e30
            m = torch.maximum(m, _cluster_scores(
                aux, score_src, score_dst, slope).max(dim=1).values)
        if extra_rowmax is not None:
            # edges outside the operator (the hierarchical layer's halo and
            # summary edges) share this softmax: their row maxima bound m
            m = torch.maximum(m, extra_rowmax.float())
    return m


def _diag_scores(aux, score_src, score_dst, slope: float) -> torch.Tensor:
    """(nb, b, b) scores of the diagonal blocks (block ``k`` holds receiver
    ``k·b + i`` and sender ``k·b + j``), −1e30 where a block has no edge."""
    nb, b, _ = aux.diag_blocks.shape
    sd = score_dst.float().reshape(nb, b)
    ss = score_src.float().reshape(nb, b)
    return torch.where(tile_values(aux.diag_blocks) > 0, _leaky(
        sd[:, :, None] + ss[:, None, :], slope), _NEG)


def _cluster_src_scores(aux, score_src: torch.Tensor) -> torch.Tensor:
    """(C,) sender scores of the cluster-summary rows: the member means of
    ``score_src`` (padding rows left out)."""
    c = aux.num_nodes // aux.cluster_size
    member = aux.cluster_member.float()
    return ((score_src.float() * member).reshape(c, aux.cluster_size).sum(1)
            * aux.cluster_scale)


def _cluster_scores(aux, score_src, score_dst, slope: float) -> torch.Tensor:
    """(N, C) scores of each receiver against each cluster-summary row,
    −1e30 where the count table has no edge."""
    return torch.where(aux.cluster_count > 0, _leaky(
        score_dst.float()[:, None]
        + _cluster_src_scores(aux, score_src)[None, :], slope), _NEG)


def tiles_two_stage(slope: float, rows, cols, plan, blocks, ssrc, sdst, m,
                    x) -> tuple:
    """The tiles' ``(num, den)`` in two stages (``att_tiles``'s contract):
    the (K, b, b) numerators ``pe`` materialised in PyTorch at the tiles'
    edge b, then K4's dynamic-tile walk (with no plan, on the einsum
    layout: a batched matmul and a sum over block rows) and a row sum."""
    b = blocks.shape[-1]
    nb = x.shape[0] // b
    mask = tile_values(blocks) > 0                  # static adjacency
    ssrc_t = ssrc.reshape(nb, b)[cols.long()]       # (K,b) sender scores
    sdst_t = sdst.reshape(nb, b)[rows.long()]       # (K,b) receiver scores
    # mask BEFORE the exp: an edgeless row's masked entries would give
    # exp(raw_e − m) = inf, and the where-backward's 0 upstream times inf is
    # a NaN gradient
    e = torch.where(mask, _leaky(sdst_t[:, :, None] + ssrc_t[:, None, :],
                                 slope), _NEG)
    mrow = m.reshape(nb, b)[rows.long()]            # (K,b)
    pe = torch.where(mask, torch.exp(e - mrow[:, :, None]), 0.0)
    if plan is None:
        slabs = x.reshape(nb, b, -1).index_select(0, cols.long())
        num = torch.zeros((nb, b, x.shape[1]), dtype=x.dtype,
                          device=x.device).index_add_(
            0, rows.long(), torch.bmm(pe.to(x.dtype), slabs)).reshape(x.shape)
    else:
        num = bsr_spmm_dyn(rows, cols, plan, pe.to(x.dtype), x)
    return num, segment_sum(pe.sum(dim=2), rows, nb).reshape(-1)
