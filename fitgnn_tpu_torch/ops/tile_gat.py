"""Tile-dense GAT attention on the hybrid BCSR/straggler operator.

On a community-reordered graph most edges live in dense 128×128 adjacency
tiles, where single-head GAT attention has a dense form with no per-edge
tensors: tile scores ``E_t[i,j] = LeakyReLU(s_dst[row_i] + s_src[col_j])``
by outer broadcast, masked by the static adjacency tile, and the weighted
aggregation as the dynamic-tile walk (K4, ``ops/bsr_dynamic.py``).  Only
the straggler edges keep the per-edge path, with K3w
(``ops/coo_segmm.py``) for aggregations of width ≤ ``SEGMM_MAX_F``.

This is the JAX package's ``tile_gat_attention`` on its default branch:
the global-bound stabilizer ``m̂[r] = max(0, s_dst[r] + max_all s_src)``
(any per-row upper bound stabilizes a shift-invariant softmax; the max
runs over every padded row and is detached where JAX has
``stop_gradient``), sender scores from the gathered message rows when
``att_src`` is given, and the softmax denominator riding the straggler
numerator scatter as an extra column.  The JAX package's environment
opt-ins (``FITGNN_GAT_SORTED_*``, ``_SEGMM_DEN`` (K6), ``_FUSED_TILES``
(K7), ``_FUSED_BWD``, ``GLOBAL_MAX=0``, another ``SEGMM_MAXF``) and its
``partials``, ``src_score_bound`` and ``extra_rowmax`` arguments are not
ported (ROADMAP.md §1-2).  The port takes no setting from the environment:
a process that sets one of those opt-ins gets ``NotImplementedError``
rather than the default branch in its place.  Its ``build_hybrid`` refuses
the diagonal-tile and cluster opt-ins, so neither ``diag_blocks`` nor
``cluster_count`` reaches this module.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from fitgnn_tpu_torch.ops.bsr_dynamic import bsr_spmm_dyn
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK
from fitgnn_tpu_torch.ops.coo_segmm import segmm_weighted_spmm
from fitgnn_tpu_torch.ops.segment import segment_sum, take_rows

# the JAX package's default width gate for the K3w straggler numerator
SEGMM_MAX_F = 64

_NEG = -1e30  # "minus infinity" that survives exp/where without NaNs

# the JAX package's opt-in environment variables and their default values
_JAX_OPT_IN_DEFAULTS = {
    "FITGNN_GAT_SORTED_SRC": "0", "FITGNN_GAT_SORTED_NUM": "0",
    "FITGNN_GAT_SEGMM_MAXF": str(SEGMM_MAX_F), "FITGNN_GAT_SEGMM_DEN": "0",
    "FITGNN_GAT_FUSED_TILES": "0", "FITGNN_GAT_GLOBAL_MAX": "1",
    "FITGNN_GAT_FUSED_BWD": "0", "FITGNN_GAT_FUSED_SORTED_DH": "0"}


def _refuse_jax_opt_ins() -> None:
    """Raise when the environment asks for a branch the port lacks."""
    asked = [f"{k}={os.environ[k]}" for k, v in _JAX_OPT_IN_DEFAULTS.items()
             if os.environ.get(k, v) != v]
    if asked:
        raise NotImplementedError(
            f"tile_gat_attention: {', '.join(asked)} selects a branch of the "
            "JAX package that is not ported (ROADMAP.md §2: K6, K7 and the "
            "diagnostic variants); unset it")


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


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
    Returns (N, F)."""
    _refuse_jax_opt_ins()
    if partials or src_score_bound is not None or extra_rowmax is not None:
        raise NotImplementedError(
            "tile_gat_attention: partials, src_score_bound and extra_rowmax "
            "serve the hierarchical distributed layer, not ported yet "
            "(ROADMAP.md §1 item 4)")
    n = aux.num_nodes
    f = h.shape[-1]
    senders, receivers = aux.senders, aux.receivers

    # ---- straggler per-edge scores (receiver-sorted lists) ----------------
    sm = aux.weights > 0
    use_segmm = aux.segmm is not None and f <= SEGMM_MAX_F
    y = None
    if att_src is not None and not use_segmm:
        y = take_rows(h, senders)                   # reused by the numerator
        ssrc_e = y.float() @ att_src.float()
    else:
        ssrc_e = take_rows(score_src, senders)
    sdst_e = take_rows(score_dst, receivers)
    es = torch.where(sm, _leaky(ssrc_e + sdst_e, negative_slope), _NEG)

    # global-bound stabilizer: LeakyReLU(sdst[r] + ssrc[s]) ≤
    # max(0, sdst[r] + max ssrc), one reduction over all rows
    maxs = score_src.float().max().detach()
    m = (score_dst.float() + maxs).clamp_min(0.0).detach()
    m_e = (sdst_e.float() + maxs).clamp_min(0.0).detach()

    # ---- straggler numerator and denominator ------------------------------
    pes = torch.exp(es - m_e) * sm
    if use_segmm:
        num = segmm_weighted_spmm(aux.segmm, aux.t_segmm, senders, receivers,
                                  aux.t_edge_perm, pes, h)
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
                         num, den)


def _finish_tiles(aux, score_src, score_dst, h, negative_slope, m, num, den):
    """Add the tile attention to the straggler (num, den) and normalize."""
    bsr = aux.bsr
    n = aux.num_nodes
    if bsr is not None:
        nb = n // BLOCK
        rows, cols = bsr.rows.long(), bsr.cols.long()
        mask = bsr.blocks > 0                       # (K,b,b) static adjacency
        ssrc = score_src.reshape(nb, BLOCK)[cols]   # (K,b) sender scores
        sdst = score_dst.reshape(nb, BLOCK)[rows]   # (K,b) receiver scores
        # mask BEFORE the exp: an edgeless row's masked entries would give
        # exp(raw_e − m) = inf, and the where-backward's 0 upstream times
        # inf is a NaN gradient
        e = torch.where(mask, _leaky(sdst[:, :, None] + ssrc[:, None, :],
                                     negative_slope), _NEG)
        mrow = m.reshape(nb, BLOCK)[rows]           # (K,b)
        pe = torch.where(mask, torch.exp(e - mrow[:, :, None]), 0.0)
        num = num + bsr_spmm_dyn(bsr.rows, bsr.cols, aux.dyn_plan,
                                 pe.to(h.dtype), h)
        den = den + segment_sum(pe.sum(dim=2), rows, nb).reshape(n)
    den = den.clamp_min(1e-16).to(h.dtype)
    return num / den[:, None]
