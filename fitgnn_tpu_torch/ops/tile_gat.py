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
  K6 at any width, with sender scores gathered from ``score_src``.

The JAX package's diagnostic switches ``FITGNN_GAT_FUSED_BWD``,
``_FUSED_SORTED_DH``, ``_SORTED_SRC`` and ``_SORTED_NUM`` (no Pallas
kernel) and its ``partials``, ``src_score_bound`` and ``extra_rowmax``
arguments are not ported: they raise ``NotImplementedError`` rather than
run the default branch in their place.  Under ``att_unit``
``build_hybrid`` refuses ``use_diag``, ``use_rowwalk`` and ``tile_group >
1`` (and, for every semantics, the cluster opt-ins), so the tiles here are
in the grid-walk layout and neither ``diag_blocks`` nor ``cluster_count``
reaches this module.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from fitgnn_tpu_torch.ops.att_bsr import MAX_F, att_rowmax, att_rowmax_plain, \
    att_tiles
from fitgnn_tpu_torch.ops.bsr_dynamic import bsr_spmm_dyn
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK
from fitgnn_tpu_torch.ops.coo_segmm import segmm_weighted_spmm, \
    segmm_weighted_spmm_den
from fitgnn_tpu_torch.ops.segment import segment_sum, take_rows

_NEG = -1e30  # "minus infinity" that survives exp/where without NaNs

# the JAX package's diagnostic switches the port refuses
_REFUSED = ("FITGNN_GAT_FUSED_BWD", "FITGNN_GAT_FUSED_SORTED_DH",
            "FITGNN_GAT_SORTED_SRC", "FITGNN_GAT_SORTED_NUM")


@dataclasses.dataclass(frozen=True)
class Switches:
    """The JAX package's ``tile_gat`` switches, with its defaults."""

    fused_tiles: bool = False       # FITGNN_GAT_FUSED_TILES
    global_max: bool = True         # FITGNN_GAT_GLOBAL_MAX
    segmm_den: bool = False         # FITGNN_GAT_SEGMM_DEN
    segmm_max_f: int = 64           # FITGNN_GAT_SEGMM_MAXF


def switches() -> Switches:
    """Read the switches from the environment as the JAX package reads
    them; raise for a diagnostic switch the port lacks."""
    env = os.environ.get
    asked = [f"{k}=1" for k in _REFUSED if env(k, "0") == "1"]
    if asked:
        raise NotImplementedError(
            f"tile_gat_attention: {', '.join(asked)} selects a diagnostic "
            "branch of the JAX package that is not ported (ROADMAP.md §2); "
            "unset it")
    return Switches(fused_tiles=env("FITGNN_GAT_FUSED_TILES", "0") == "1",
                    global_max=env("FITGNN_GAT_GLOBAL_MAX", "1") == "1",
                    segmm_den=env("FITGNN_GAT_SEGMM_DEN", "0") == "1",
                    segmm_max_f=int(env("FITGNN_GAT_SEGMM_MAXF", "64")))


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
    sw = switches()
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
    use_segmm_den = sw.segmm_den and aux.segmm is not None
    use_segmm = (aux.segmm is not None and f <= sw.segmm_max_f
                 and not use_segmm_den)
    y = None
    if att_src is not None and not use_segmm and not use_segmm_den:
        y = take_rows(h, senders)                   # reused by the numerator
        ssrc_e = y.float() @ att_src.float()
    else:
        ssrc_e = take_rows(score_src, senders)
    sdst_e = take_rows(score_dst, receivers)
    es = torch.where(sm, _leaky(ssrc_e + sdst_e, negative_slope), _NEG)

    fused = (aux.bsr is not None and aux.dyn_plan is not None and f <= MAX_F
             and sw.fused_tiles)
    if sw.global_max:
        # LeakyReLU(sdst[r] + ssrc[s]) ≤ max(0, sdst[r] + max ssrc), one
        # reduction over all rows
        maxs = score_src.float().max().detach()
        m = (score_dst.float() + maxs).clamp_min(0.0).detach()
        m_e = (sdst_e.float() + maxs).clamp_min(0.0).detach()
    else:
        m = _exact_max(aux, es, score_src, score_dst, negative_slope, fused)
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
    else:
        if y is None:
            y = take_rows(h, senders)
        # the denominator rides the numerator scatter as an extra column
        pcol = pes[:, None].to(h.dtype)
        num_aug = segment_sum(torch.cat([y * pcol, pcol], dim=1), receivers,
                              n)
        num = num_aug[:, :f]
        den = num_aug[:, f].float()

    # ---- the tiles' contribution, then normalize ---------------------------
    bsr = aux.bsr
    if bsr is not None:
        tiles = att_tiles if fused else tiles_two_stage
        num_t, den_t = tiles(negative_slope, bsr.rows, bsr.cols, aux.dyn_plan,
                             bsr.blocks, score_src.float(), score_dst.float(),
                             m, h)
        num = num + num_t.to(num.dtype)
        den = den + den_t
    den = den.clamp_min(1e-16).to(h.dtype)
    return num / den[:, None]


def _exact_max(aux, es, score_src, score_dst, slope: float,
               fused: bool) -> torch.Tensor:
    """The exact per-receiver max over straggler and tile scores, detached;
    −1e30 where a row has no edge (never 0: a row whose every score sits
    below −88 would underflow its denominator to 0)."""
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
    return m


def tiles_two_stage(slope: float, rows, cols, plan, blocks, ssrc, sdst, m,
                    x) -> tuple:
    """The tiles' ``(num, den)`` in two stages (``att_tiles``'s contract):
    the (K, b, b) numerators ``pe`` materialised in PyTorch, then K4's
    dynamic-tile walk and a row sum."""
    nb = x.shape[0] // BLOCK
    mask = blocks > 0                               # static adjacency
    ssrc_t = ssrc.reshape(nb, BLOCK)[cols.long()]   # (K,b) sender scores
    sdst_t = sdst.reshape(nb, BLOCK)[rows.long()]   # (K,b) receiver scores
    # mask BEFORE the exp: an edgeless row's masked entries would give
    # exp(raw_e − m) = inf, and the where-backward's 0 upstream times inf is
    # a NaN gradient
    e = torch.where(mask, _leaky(sdst_t[:, :, None] + ssrc_t[:, None, :],
                                 slope), _NEG)
    mrow = m.reshape(nb, BLOCK)[rows.long()]        # (K,b)
    pe = torch.where(mask, torch.exp(e - mrow[:, :, None]), 0.0)
    num = bsr_spmm_dyn(rows, cols, plan, pe.to(x.dtype), x)
    return num, segment_sum(pe.sum(dim=2), rows, nb).reshape(-1)
