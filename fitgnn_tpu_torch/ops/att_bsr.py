"""Fused tile attention for GAT (K7): the tile scores worked out inside the
kernels from the per-node score vectors, never materialised.

The two-stage tile path (``ops/tile_gat.py``, ``tiles_two_stage``) builds
the (K, b, b) tensors ``e = LeakyReLU(s_dst ⊕ s_src)`` and
``pe = exp(e − m)·mask`` in PyTorch and hands ``pe`` to K4.  At the bench
graph's 2,192 tiles each such tensor is 143.6 MB, written and read again
several times a training step.  These kernels read only the static
presence tiles, the (n,) score vectors and the feature slabs, as the JAX
package's ``ops/pallas/att_bsr.py`` does:

* ``att_rowmax`` — the per-node max of the masked tile scores (the exact
  softmax max), −1e30 where a node has no tile in-edge;
* ``att_fwd`` — ``num = Σ_tile pe @ x[cols]`` and ``den = Σ_tile Σ_j pe``;
* ``att_bwd_scores`` — both score gradients in one pass: ``dsdst`` (the
  row sums of ``d_raw``) and ``dssrc`` (its column sums), from one
  tensor-core product per tile and a deterministic kernel (``att_sums``)
  that adds its partials over the forward walk and the transpose plan;
* ``att_bwd_t`` — ``dx`` (``peᵀ @ g`` on the transpose plan) and
  ``dssrc``, each on request; ``att_bwd_f`` — ``dsdst`` (the two halves of
  the JAX package's backward, kept for its entry points);

with ``pe = exp(LeakyReLU(sdst_i + ssrc_j) − m_i)`` at the tile's entries
and ``d_raw = LeakyReLU'(raw)·pe·(⟨g_i, x_j⟩ + dden_i)`` there.  The exp
is taken only at the mask's entries (the TPU kernels mask after it), so a
row whose ``m`` is −1e30 never overflows.  ``att_tiles`` is the autograd
Function over them, differentiable in ``ssrc``, ``sdst`` and ``x``; ``m``
is a constant, as under the JAX package's ``stop_gradient``.  Its backward
launches ``att_bwd_scores`` once for both score gradients and the ``dx``
walk alone.  0 < F ≤ 512.

Each wrapper launches the hand-written kernels of ``csrc/att_bsr.cu`` on
CUDA tensors (the source note there says which TPU kernel each replaces,
what bounds it on an H100 and what its design does about it; ``att_fwd``
and ``att_bwd_t``'s ``dx`` run the non-zero walk of
``csrc/tile_sparse.cuh`` with ``pe`` worked out per non-zero, and
``att_bwd_scores`` the tensor-core product of ``csrc/tf32x3.cuh``) and its
plain PyTorch version (``*_plain``: materialised tiles, ``bmm`` and
``index_add_``) on CPU tensors.  ``<wrapper>.launches`` counts kernel
launches.

Tiles of any edge E that is a multiple of 128 (the JAX package's
``build_hybrid(block=E, semantics="att_unit")``): the kernels take E from
the tiles' shape and walk an E-wide tile as 128-wide quadrants (the
source note says how); the score pass's partials are then (K, nq·E), nq =
E / 128 (``att_scores_plain``).  Where the plan carries the mask's
occupancy words (``DynPlan.words``, ``t_words`` and ``live``, E of 256 to
1024), K7f and K7bt's ``dx`` walk the live quadrants alone, the score
pass runs a CTA on each live quadrant alone and ``att_sums`` reads their
partials alone; each gives the launch without them bit for bit.  The
plain versions read none of them: they stay the JAX package's dense
computation.  Every wrapper refuses another edge with ``ValueError``, on
the CPU too.  ``ops/tile_gat.py``'s exact max without
``FUSED_TILES`` runs ``att_rowmax_plain`` at E on any device.

bf16 tiles (``train --hybrid_bf16_tiles``): the tiles are GAT's 0/1 mask,
exact in bf16, so only their type changes; ``pe``, ``x``, ``g`` and every
sum stay f32 and nothing is rounded, as in the JAX package, which passes
its bf16 tiles to the same kernels.  The wrappers that read the tiles
(``att_rowmax``, ``att_fwd``, ``att_bwd_t``'s ``dx`` walk and
``att_bwd_scores``) launch the kernels' bf16 forms on them (the C entries
ending in ``_bf16``) and count those in ``<wrapper>.launches_bf16``.
f16 and fp8 masks reach the card widened to f32 (``BsrMatrix``), so
they take the f32 forms; the plain versions read them on the CPU.

bf16 activations (the JAX package's conv-stack ``dtype=bfloat16``): no K7
form reads them narrow.  ``att_fwd``, ``att_bwd_t`` and
``att_bwd_scores`` take the widened route (``kernels.widened``): ``x`` and
``g`` widened to f32, the form for the mask's type launched and counted
as usual, ``num`` and ``dx`` rounded to bf16 once, ``den`` and the score
gradients left f32, on either device.  The Pallas kernels cast ``pe`` to
the activations' type before its product; here ``pe`` stays f32
(``ROADMAP.md`` §3).
"""

from __future__ import annotations

import ctypes
import math

import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.ops.bsr_dynamic import DynPlan
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK, check_block, tile_nonzero

NEG = -1e30
MAX_F = 512


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


def _slabs(v: torch.Tensor, idx: torch.Tensor, e: int) -> torch.Tensor:
    """Rows of ``v`` ((n,) or (n, F)) by ``e``-row block: (len(idx), e[,
    F])."""
    return v.reshape(v.shape[0] // e, e, *v.shape[1:]).index_select(
        0, idx.long())


def _tile_pe(blocks, ssrc, sdst, m, row_blk, col_blk, slope):
    """mask, raw and pe of tiles whose rows are block ``row_blk[k]`` and
    columns block ``col_blk[k]`` (blocks of the tiles' edge); masked
    before the exp."""
    b = blocks.shape[-1]
    mask = tile_nonzero(blocks)
    raw = (_slabs(sdst, row_blk, b)[:, :, None]
           + _slabs(ssrc, col_blk, b)[:, None, :])
    e = torch.where(mask, _leaky(raw, slope), NEG)
    pe = torch.where(mask, torch.exp(e - _slabs(m, row_blk, b)[:, :, None]),
                     0.0)
    return mask, raw, pe


def _d_raw(mask, raw, pe, gs, xs, dden_rows, slope):
    """``LeakyReLU'(raw)·pe·(g_i·x_j + dden_i)`` at the mask's entries."""
    d_pe = torch.bmm(gs, xs.transpose(1, 2)) + dden_rows[:, :, None]
    d_raw = torch.where(mask, d_pe * pe, 0.0)
    return torch.where(raw >= 0, d_raw, slope * d_raw)


def _sum_by_block(vals, idx, nb) -> torch.Tensor:
    """``out[idx[k]] += vals[k]`` over (K, b[, F]) values, flattened."""
    out = torch.zeros((nb,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, idx.long(), vals).reshape(
        nb * vals.shape[1], *vals.shape[2:])


def att_rowmax_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst,
                     slope: float) -> torch.Tensor:
    """Per-node max of the masked tile scores, −1e30 where none: the
    materialised (K, b, b) scores at the tiles' edge b, a row max and a
    segment max."""
    b = blocks.shape[-1]
    nb = ssrc.shape[0] // b
    raw = (_slabs(sdst, rows, b)[:, :, None]
           + _slabs(ssrc, cols, b)[:, None, :])
    tmax = torch.where(tile_nonzero(blocks), _leaky(raw, slope),
                       NEG).amax(dim=2)
    out = torch.full((nb, b), NEG, dtype=tmax.dtype, device=tmax.device)
    idx = rows.long()[:, None].expand_as(tmax)
    return out.scatter_reduce(0, idx, tmax, "amax",
                              include_self=True).reshape(-1)


def att_fwd_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, x,
                  slope: float) -> tuple:
    """``(num, den)`` from the materialised ``pe``; bf16 ``x`` by the
    widened route."""
    if x.dtype == torch.bfloat16:
        return kernels.widened(lambda x: att_fwd_plain(
            rows, cols, plan, blocks, ssrc, sdst, m, x, slope), x)
    b = blocks.shape[-1]
    nb = x.shape[0] // b
    _, _, pe = _tile_pe(blocks, ssrc, sdst, m, rows, cols, slope)
    num = _sum_by_block(torch.bmm(pe.to(x.dtype), _slabs(x, cols, b)), rows,
                        nb)
    return num, _sum_by_block(pe.sum(dim=2), rows, nb)


def att_bwd_t_plain(plan: DynPlan, blocks, ssrc, sdst, m, g, x, dden,
                    slope: float, need_dx: bool = True,
                    need_dssrc: bool = True) -> tuple:
    """``(dx, dssrc)``, each None unless asked for, on the transpose plan:
    slot ``k`` reads forward tile ``t_sel[k]`` (rows block ``t_cols[k]``,
    columns block ``t_rows[k]``) scaled by ``t_scale[k]`` (0 for a coverage
    filler).  bf16 ``g`` and ``x`` by the widened route."""
    if x.dtype == torch.bfloat16:
        return kernels.widened(lambda g, x: att_bwd_t_plain(
            plan, blocks, ssrc, sdst, m, g, x, dden, slope, need_dx,
            need_dssrc), g, x)
    b = blocks.shape[-1]
    nb = x.shape[0] // b
    mask, raw, pe = _tile_pe(blocks.index_select(0, plan.t_sel.long()), ssrc,
                             sdst, m, plan.t_cols, plan.t_rows, slope)
    sc = plan.t_scale.to(pe.dtype)[:, None, None]
    gs = _slabs(g, plan.t_cols, b)
    dx = dssrc = None
    if need_dx:
        dx = _sum_by_block(sc * torch.bmm(pe.transpose(1, 2).to(g.dtype), gs),
                           plan.t_rows, nb)
    if need_dssrc:
        d_raw = _d_raw(mask, raw, pe, gs.float(),
                       _slabs(x, plan.t_rows, b).float(),
                       _slabs(dden, plan.t_cols, b), slope)
        dssrc = _sum_by_block((sc * d_raw).sum(dim=1), plan.t_rows, nb)
    return dx, dssrc


def att_bwd_f_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g, x,
                    dden, slope: float) -> torch.Tensor:
    """``dsdst``: the row sums of ``d_raw`` on the forward walk."""
    rpart = att_scores_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                             dden, slope)[1]
    b = blocks.shape[-1]
    return _sum_by_block(_tile_sums(rpart), rows, x.shape[0] // b)


def att_scores_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g, x,
                     dden, slope: float) -> tuple:
    """The score-gradient pass: ``(cpart, rpart)``, each forward tile's
    ``d_raw`` summed over one 128-wide quadrant slice of an axis, (K, nq·b)
    each for tiles of edge b = 128·nq: ``rpart[k, qj·b + i]`` row ``i``'s
    sum over the columns of quadrant column ``qj``, ``cpart[k, qi·b + j]``
    column ``j``'s over the rows of quadrant row ``qi`` (at b = 128 the
    tile's row and column sums, (K, 128))."""
    b = blocks.shape[-1]
    nq = b // BLOCK
    mask, raw, pe = _tile_pe(blocks, ssrc, sdst, m, rows, cols, slope)
    d_raw = _d_raw(mask, raw, pe, _slabs(g, rows, b).float(),
                   _slabs(x, cols, b).float(), _slabs(dden, rows, b), slope)
    k = d_raw.shape[0]
    cpart = d_raw.reshape(k, nq, BLOCK, b).sum(dim=2)
    rpart = d_raw.reshape(k, b, nq, BLOCK).sum(dim=3).transpose(1, 2)
    return cpart.reshape(k, nq * b), rpart.reshape(k, nq * b)


def _part_edge(what: str, part) -> int:
    """The tile edge b of partials (K, nq·b), b = 128·nq."""
    nq = math.isqrt(part.shape[-1] // BLOCK) if part.dim() == 2 else 0
    if nq < 1 or part.shape[-1] != nq * nq * BLOCK:
        raise ValueError(f"{what}: partials {tuple(part.shape)} must be "
                         f"(K, nq·E) with E = nq·{BLOCK}, a multiple of "
                         f"{BLOCK}")
    return nq * BLOCK


def _tile_sums(part) -> torch.Tensor:
    """A tile's full row (column) sums, (K, b), from its nq partials."""
    b = _part_edge("att_sums", part)
    return part.reshape(part.shape[0], -1, b).sum(dim=1)


def att_sums_plain(plan: DynPlan, cpart, rpart) -> tuple:
    """``(dssrc, dsdst)`` from the pass's partials: ``dssrc[c] = Σ
    scale·cpart[t_sel]`` over the transpose plan's slots of block ``c`` (a
    coverage filler, scale 0, adds nothing), ``dsdst[r]`` the row partials
    of block row ``r``'s tiles; a tile's nq partials summed first."""
    nb = plan.row_splits.shape[0] - 1
    csum, rsum = _tile_sums(cpart), _tile_sums(rpart)
    sc = plan.t_scale[:, None]
    vals = torch.where(sc != 0, sc.to(csum.dtype)
                       * csum.index_select(0, plan.t_sel.long()), 0.0)
    rows = torch.repeat_interleave(
        torch.arange(nb, device=rpart.device),
        (plan.row_splits[1:] - plan.row_splits[:-1]).long())
    return (_sum_by_block(vals, plan.t_rows, nb),
            _sum_by_block(rsum, rows, nb))


def att_bwd_scores_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g,
                         x, dden, slope: float) -> tuple:
    """``(dssrc, dsdst)`` as the JAX package's two kernels give them: the
    column sums of ``d_raw`` on the transpose plan, its row sums on the
    forward walk."""
    return (att_bwd_t_plain(plan, blocks, ssrc, sdst, m, g, x, dden, slope,
                            need_dx=False)[1],
            att_bwd_f_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                            dden, slope))


# blocks, row_splits, cols, ssrc, sdst, out, num_row_blocks, block, slope,
# stream
_ROWMAX_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
                    + [ctypes.c_float, ctypes.c_void_p])
# blocks, splits, sel, scale, cols, words, ssrc, sdst, m, x, out, den,
# num_row_blocks, feat, block, trans, slope, stream
_WALK_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 3
                  + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
# blocks, rows, cols, live, ssrc, sdst, m, dden, g, x, cpart, rpart,
# num_tiles, num_live, feat, block, slope, stream
_SCORES_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_int64] * 4
                    + [ctypes.c_float, ctypes.c_void_p])
# cpart, rpart, row_splits, t_row_splits, t_sel, t_scale, words, t_words,
# dssrc, dsdst, num_row_blocks, block, stream
_SUMS_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 2
                  + [ctypes.c_void_p])

_NULL = ctypes.c_void_p(None)


def _check(what: str, blocks, splits, vectors: dict, feats: dict = None,
           ints: dict = None) -> torch.device:
    """Validate the operands of a K7 launch (``splits`` is the walk's CSR
    over the tile rows); returns their device."""
    n = next(iter(vectors.values())).shape[0]
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    e = _edge(what, blocks)
    kernels.require(splits, "splits", torch.int32, dev)
    if n % e:
        raise ValueError(f"{what}: {n} nodes is not a multiple of the tile "
                         f"edge {e}")
    if splits.shape[0] != n // e + 1:
        raise ValueError(f"{what}: {splits.shape[0]} splits for "
                         f"{n // e} tile rows")
    if blocks.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: blocks must be f32 or bf16, got "
                         f"{blocks.dtype}")
    kernels.require(blocks, "blocks", blocks.dtype, dev)
    if blocks.data_ptr() % 16:
        raise ValueError(f"{what}: blocks must be 16-byte aligned")
    for name, v in vectors.items():
        kernels.require(v, name, torch.float32, dev)
        if v.shape != (n,):
            raise ValueError(f"{what}: {name} {tuple(v.shape)} must be "
                             f"({n},)")
    feat = None
    for name, v in (feats or {}).items():
        kernels.require(v, name, torch.float32, dev)
        if v.dim() != 2 or v.shape[0] != n:
            raise ValueError(f"{what}: {name} {tuple(v.shape)} must be "
                             f"({n}, F)")
        if feat is not None and v.shape[1] != feat:
            raise ValueError(f"{what}: feature widths differ")
        feat = v.shape[1]
    if feat is not None and not 0 < feat <= MAX_F:
        raise ValueError(f"{what}: F={feat} outside 1..{MAX_F}")
    for name, t in (ints or {}).items():
        kernels.require(t, name, torch.int32, dev)
    return dev


def _edge(what: str, blocks) -> int:
    """The tiles' edge E: (K, E, E) with E a positive multiple of 128."""
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"{what}: blocks {tuple(blocks.shape)} must be "
                         "(K, E, E)")
    check_block(blocks.shape[-1])
    return blocks.shape[-1]


def att_rowmax(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
               blocks: torch.Tensor, ssrc: torch.Tensor, sdst: torch.Tensor,
               slope: float) -> torch.Tensor:
    """K7rm: per-node max of the masked tile scores, (n,) f32, −1e30 where
    a node has no tile in-edge: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  ``rows`` sorted, walked by
    ``plan.row_splits``."""
    if ssrc.device.type == "cpu":
        _edge("att_rowmax", blocks)
        return att_rowmax_plain(rows, cols, plan, blocks, ssrc, sdst, slope)
    dev = _check("att_rowmax", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst), ints=dict(cols=cols))
    out = torch.empty_like(ssrc)
    launch = kernels.function("att_bsr", kernels.entry("fitgnn_att_rowmax", blocks),
                              _ROWMAX_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(plan.row_splits),
                    kernels.ptr(cols), kernels.ptr(ssrc), kernels.ptr(sdst),
                    kernels.ptr(out), plan.row_splits.shape[0] - 1,
                    blocks.shape[-1], float(slope), kernels.stream(dev))
    kernels.check(rc, "att_rowmax")
    kernels.count(att_rowmax, blocks)
    return out


def _ptr(t):
    return _NULL if t is None else kernels.ptr(t)


def _launch_walk(what, dev, blocks, splits, sel, scale, cols, words, ssrc,
                 sdst, m, x, den, trans: bool, slope: float) -> torch.Tensor:
    """One launch of the tile walk (forward or the transpose plan's dx);
    ``words`` the slots' occupancy words (the forward tiles' ``words``, the
    transpose slots' ``t_words``) or None (the walk of every quadrant).
    Given words, a tile edge the walk of the live quadrants does not take
    (128, above 1024) raises: there is no fallback to the walk without
    them."""
    if words is not None:
        kernels.require(words, "words", torch.int64, blocks.device)
        if words.shape != cols.shape:
            raise ValueError(f"{what}: words {tuple(words.shape)} for "
                             f"{cols.shape[0]} slots")
    out = torch.empty_like(x)
    launch = kernels.function("att_bsr", kernels.entry("fitgnn_att_walk", blocks),
                              _WALK_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(splits), _ptr(sel),
                    _ptr(scale), kernels.ptr(cols), _ptr(words),
                    kernels.ptr(ssrc), kernels.ptr(sdst), kernels.ptr(m),
                    kernels.ptr(x), kernels.ptr(out), _ptr(den),
                    splits.shape[0] - 1, x.shape[1], blocks.shape[-1],
                    int(trans), float(slope), kernels.stream(dev))
    kernels.check(rc, what)
    return out


def _launch_scores(what, dev, blocks, rows, cols, live, ssrc, sdst, m, g, x,
                   dden, slope: float) -> tuple:
    """One launch of the score-gradient pass: ``(cpart, rpart)``, (K, nq·b)
    each (``att_scores_plain``'s layout).  ``live`` the quadrants to run
    (``DynPlan.live``) or None (every quadrant of every tile); given, the
    partials start from zeros, which the empty quadrants keep (the +0 that
    their CTAs write without it), and a tile edge of 128 raises."""
    b = blocks.shape[-1]
    shape = (2, blocks.shape[0], b // BLOCK * b)
    if live is None:
        cpart, rpart = torch.empty(shape, dtype=torch.float32, device=dev)
    else:
        kernels.require(live, "live", torch.int32, blocks.device)
        if live.dim() != 1:
            raise ValueError(f"{what}: live {tuple(live.shape)} must be "
                             "(L,)")
        cpart, rpart = torch.zeros(shape, dtype=torch.float32, device=dev)
    launch = kernels.function("att_bsr", kernels.entry("fitgnn_att_scores", blocks),
                              _SCORES_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(rows), kernels.ptr(cols),
                    _ptr(live), kernels.ptr(ssrc), kernels.ptr(sdst),
                    kernels.ptr(m), kernels.ptr(dden), kernels.ptr(g),
                    kernels.ptr(x), kernels.ptr(cpart), kernels.ptr(rpart),
                    blocks.shape[0], 0 if live is None else live.shape[0],
                    x.shape[1], b, float(slope), kernels.stream(dev))
    kernels.check(rc, what)
    return cpart, rpart


def att_fwd(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
            blocks: torch.Tensor, ssrc: torch.Tensor, sdst: torch.Tensor,
            m: torch.Tensor, x: torch.Tensor, slope: float) -> tuple:
    """K7f: ``(num (n, F), den (n,))`` of the tiles' softmax numerators
    worked out in the kernel, every row written: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.  With ``plan.words`` (edge
    256 to 1024) the kernel walks the live quadrants alone, which gives the
    walk of every quadrant bit for bit: ``plan.words`` must be the
    occupancy words of ``blocks`` (the mask the plan was built from, or a
    cast of it with the same non-zeros, as the bf16 cast of a 0/1 mask).
    bf16 ``x`` through ``kernels.widened`` (``num`` bf16, ``den`` f32)."""
    if kernels.narrow("att_fwd", x):
        return kernels.widened(lambda x: att_fwd(rows, cols, plan, blocks,
                                                 ssrc, sdst, m, x, slope), x)
    if x.device.type == "cpu":
        _edge("att_fwd", blocks)
        return att_fwd_plain(rows, cols, plan, blocks, ssrc, sdst, m, x,
                             slope)
    dev = _check("att_fwd", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m), dict(x=x), dict(cols=cols))
    den = torch.empty_like(ssrc)
    num = _launch_walk("att_fwd", dev, blocks, plan.row_splits, None, None,
                       cols, plan.words, ssrc, sdst, m, x, den, False, slope)
    kernels.count(att_fwd, blocks)
    return num, den


def att_sums(plan: DynPlan, cpart: torch.Tensor,
             rpart: torch.Tensor) -> tuple:
    """K7's partial sums: ``(dssrc, dsdst)`` (n,) from the score-gradient
    pass's column and row partials (K, nq·b), summed over the transpose
    plan's slots and the forward walk's tiles in order: the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor.  On the card the
    partials must be 16-byte aligned (``torch.empty`` and ``torch.zeros``
    give that).  With ``plan.words`` and ``plan.t_words`` (edge 256 to
    1024) the kernel reads the partials of the live quadrants alone: bit
    ``h·nq + u`` of ``words[k]`` for ``rpart[k, u·b + 128·h : +128]``, of
    ``t_words[s]`` for ``cpart[t_sel[s], u·b + 128·h : +128]``.  The
    contract: a quadrant whose bit is clear must hold zeros in both
    partials (the +0 that ``att_bwd_scores``' pass writes there); then the
    result is the sum of every partial bit for bit, and otherwise what
    stands there is left out."""
    b = _part_edge("att_sums", cpart)
    if rpart.shape != cpart.shape:
        raise ValueError(f"att_sums: rpart {tuple(rpart.shape)} and cpart "
                         f"{tuple(cpart.shape)} differ")
    if cpart.device.type == "cpu":
        return att_sums_plain(plan, cpart, rpart)
    dev = cpart.device
    for name, t in (("cpart", cpart), ("rpart", rpart)):
        kernels.require(t, name, torch.float32, dev)
    for name in ("row_splits", "t_row_splits", "t_sel", "t_scale"):
        kernels.require(getattr(plan, name), name, torch.int32, dev)
    nb = plan.row_splits.shape[0] - 1
    if plan.t_row_splits.shape[0] != nb + 1:
        raise ValueError("att_sums: the plan's two walks cover "
                         "different block counts")
    if (plan.words is None) != (plan.t_words is None):
        raise ValueError("att_sums: the plan has words for one walk only")
    if plan.words is not None:
        for name, t, k in (("words", plan.words, cpart.shape[0]),
                           ("t_words", plan.t_words, plan.t_sel.shape[0])):
            kernels.require(t, name, torch.int64, dev)
            if t.shape != (k,):
                raise ValueError(f"att_sums: {name} {tuple(t.shape)} for "
                                 f"{k} slots")
    dssrc, dsdst = torch.empty((2, nb * b), dtype=torch.float32,
                               device=dev)
    for name, t in (("cpart", cpart), ("rpart", rpart), ("dssrc", dssrc),
                    ("dsdst", dsdst)):
        if t.data_ptr() % 16:
            raise ValueError(f"att_sums: {name} is not 16-byte aligned")
    launch = kernels.function("att_bsr", "fitgnn_att_sums", _SUMS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(cpart), kernels.ptr(rpart),
                    kernels.ptr(plan.row_splits),
                    kernels.ptr(plan.t_row_splits), kernels.ptr(plan.t_sel),
                    kernels.ptr(plan.t_scale), _ptr(plan.words),
                    _ptr(plan.t_words), kernels.ptr(dssrc),
                    kernels.ptr(dsdst), nb, b, kernels.stream(dev))
    kernels.check(rc, "att_sums")
    att_sums.launches += 1
    return dssrc, dsdst


def att_bwd_scores(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
                   blocks: torch.Tensor, ssrc: torch.Tensor,
                   sdst: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                   x: torch.Tensor, dden: torch.Tensor,
                   slope: float) -> tuple:
    """K7bt's ``dssrc`` and K7bf's ``dsdst``, ``(dssrc, dsdst)``: on a CUDA
    tensor one launch of the score-gradient pass over the forward tiles
    (counted here; ``rows`` sorted, ``plan.row_splits`` their CSR), then
    ``att_sums`` on its partials; the plain version on a CPU tensor.  With
    ``plan.live`` (edge 256 to 1024) the pass runs one CTA a live quadrant
    and no other, bit for bit the pass over every quadrant (an empty
    quadrant's partials are +0 either way): ``plan.words``, whose live
    quadrants ``plan.live`` lists, must be the occupancy words of
    ``blocks`` (the mask the plan was built from, or a cast of it with the
    same non-zeros).  bf16 ``g`` and ``x`` through ``kernels.widened``."""
    if kernels.narrow("att_bwd_scores", x):
        return kernels.widened(
            lambda g, x: att_bwd_scores(rows, cols, plan, blocks, ssrc, sdst,
                                        m, g, x, dden, slope), g, x,
            rounds=())
    if x.device.type == "cpu":
        _edge("att_bwd_scores", blocks)
        return att_bwd_scores_plain(rows, cols, plan, blocks, ssrc, sdst, m,
                                    g, x, dden, slope)
    dev = _check("att_bwd_scores", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m, dden=dden), dict(g=g, x=x),
                 dict(rows=rows, cols=cols))
    if not rows.shape[0] == cols.shape[0] == blocks.shape[0]:
        raise ValueError(f"att_bwd_scores: {rows.shape[0]} rows and "
                         f"{cols.shape[0]} cols for {blocks.shape[0]} tiles")
    cpart, rpart = _launch_scores("att_bwd_scores", dev, blocks, rows, cols,
                                  plan.live, ssrc, sdst, m, g, x, dden,
                                  slope)
    kernels.count(att_bwd_scores, blocks)
    return att_sums(plan, cpart, rpart)


def _forward_tiles(plan: DynPlan, k: int) -> tuple:
    """The forward tiles' ``(rows, cols)`` block ids, read back from the
    transpose plan (every real tile is one slot, at ``t_sel``, in row block
    ``t_cols`` and column block ``t_rows``)."""
    real = plan.t_scale != 0
    sel = plan.t_sel[real].long()
    rows, cols = torch.zeros((2, k), dtype=torch.int32,
                             device=plan.t_sel.device)
    rows[sel] = plan.t_cols[real]
    cols[sel] = plan.t_rows[real]
    return rows, cols


def att_bwd_t(plan: DynPlan, blocks: torch.Tensor, ssrc: torch.Tensor,
              sdst: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
              x: torch.Tensor, dden: torch.Tensor, slope: float,
              need_dx: bool = True, need_dssrc: bool = True) -> tuple:
    """K7bt: ``(dx, dssrc)`` on the transpose plan, each None unless asked
    for: on a CUDA tensor the walk kernel for ``dx`` (counted here) and
    ``att_bwd_scores`` for ``dssrc``, the plain version on a CPU tensor.
    With ``plan.t_words`` (edge 256 to 1024) the ``dx`` walk takes the live
    quadrants alone, which gives the walk of every quadrant bit for bit:
    ``plan.t_words`` must be the transposed occupancy words of the tiles
    each slot reads (the mask the plan was built from, or a cast of it
    with the same non-zeros, as the bf16 cast of a 0/1 mask).  bf16 ``g``
    and ``x`` through ``kernels.widened`` (``dx`` bf16, ``dssrc`` f32)."""
    if kernels.narrow("att_bwd_t", x):
        return kernels.widened(
            lambda g, x: att_bwd_t(plan, blocks, ssrc, sdst, m, g, x, dden,
                                   slope, need_dx, need_dssrc), g, x)
    if x.device.type == "cpu":
        _edge("att_bwd_t", blocks)
        return att_bwd_t_plain(plan, blocks, ssrc, sdst, m, g, x, dden,
                               slope, need_dx, need_dssrc)
    dev = _check("att_bwd_t", blocks, plan.t_row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m, dden=dden), dict(g=g, x=x),
                 dict(t_sel=plan.t_sel, t_scale=plan.t_scale,
                      t_cols=plan.t_cols))
    dx = dssrc = None
    if need_dx:
        dx = _launch_walk("att_bwd_t (dx)", dev, blocks, plan.t_row_splits,
                          plan.t_sel, plan.t_scale, plan.t_cols,
                          plan.t_words, ssrc, sdst, m, g, None, True, slope)
        kernels.count(att_bwd_t, blocks)
    if need_dssrc:
        dssrc = att_bwd_scores(*_forward_tiles(plan, blocks.shape[0]), plan,
                               blocks, ssrc, sdst, m, g, x, dden, slope)[0]
    return dx, dssrc


def att_bwd_f(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
              blocks: torch.Tensor, ssrc: torch.Tensor, sdst: torch.Tensor,
              m: torch.Tensor, g: torch.Tensor, x: torch.Tensor,
              dden: torch.Tensor, slope: float) -> torch.Tensor:
    """K7bf: ``dsdst`` on the forward walk: ``att_bwd_scores``' second
    output on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        _edge("att_bwd_f", blocks)
        return att_bwd_f_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                               dden, slope)
    return att_bwd_scores(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                          dden, slope)[1]


att_rowmax.launches = att_rowmax.launches_bf16 = 0
att_fwd.launches = att_fwd.launches_bf16 = 0
att_bwd_t.launches = att_bwd_t.launches_bf16 = 0
att_bwd_scores.launches = att_bwd_scores.launches_bf16 = 0
att_sums.launches = 0


class _AttTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, slope, rows, cols, plan, blocks, ssrc, sdst, m, x):
        ctx.slope, ctx.plan = slope, plan
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(rows, cols, blocks, ssrc, sdst, m, x)
        return att_fwd(rows, cols, plan, blocks, ssrc, sdst, m, x, slope)

    @staticmethod
    def backward(ctx, g, dden):
        rows, cols, blocks, ssrc, sdst, m, x = ctx.saved_tensors
        need = ctx.needs_input_grad
        g = torch.zeros_like(x) if g is None else g.contiguous().to(x.dtype)
        dden = (torch.zeros_like(ssrc) if dden is None
                else dden.contiguous().float())
        dx = dssrc = dsdst = None
        if need[5] or need[6]:
            # both score gradients in one pass (layer 0 aggregates raw
            # features, so it has no dx, but its scores need them)
            dssrc, dsdst = att_bwd_scores(rows, cols, ctx.plan, blocks, ssrc,
                                          sdst, m, g, x, dden, ctx.slope)
        if need[8]:
            dx = att_bwd_t(ctx.plan, blocks, ssrc, sdst, m, g, x, dden,
                           ctx.slope, need_dssrc=False)[0]
        return (None, None, None, None, None, dssrc if need[5] else None,
                dsdst if need[6] else None, None, dx)


def att_tiles(slope: float, rows: torch.Tensor, cols: torch.Tensor,
              plan: DynPlan, blocks: torch.Tensor, ssrc: torch.Tensor,
              sdst: torch.Tensor, m: torch.Tensor, x: torch.Tensor) -> tuple:
    """Dense-tile GAT softmax contribution ``(num, den)``: ``num[r] =
    Σ_tile pe @ x`` and ``den[r] = Σ_tile Σ_j pe`` (the JAX package's
    ``att_tiles`` without its ``block``).  ``rows``/``cols``/``plan``/
    ``blocks`` are the static tile structure; differentiable in ``ssrc``,
    ``sdst`` (per-node score projections, (n,) f32) and ``x``; ``m`` (the
    softmax stabiliser, (n,) f32) is a constant.  A backward launches only
    what its inputs need: one score-gradient pass for ``ssrc`` and
    ``sdst``, no ``dx`` walk for an ``x`` without gradient."""
    return _AttTiles.apply(slope, rows, cols, plan, blocks.contiguous(),
                           ssrc.contiguous(), sdst.contiguous(),
                           m.detach().contiguous(), x.contiguous())
