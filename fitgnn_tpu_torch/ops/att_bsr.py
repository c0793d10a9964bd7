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
"""

from __future__ import annotations

import ctypes

import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.ops.bsr_dynamic import DynPlan
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK

NEG = -1e30
MAX_F = 512


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, slope * v)


def _slabs(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``v`` ((n,) or (n, F)) by 128-row block: (len(idx), b[, F])."""
    return v.reshape(v.shape[0] // BLOCK, BLOCK, *v.shape[1:]).index_select(
        0, idx.long())


def _tile_pe(blocks, ssrc, sdst, m, row_blk, col_blk, slope):
    """mask, raw and pe of tiles whose rows are block ``row_blk[k]`` and
    columns block ``col_blk[k]``; masked before the exp."""
    mask = blocks != 0
    raw = _slabs(sdst, row_blk)[:, :, None] + _slabs(ssrc, col_blk)[:, None, :]
    e = torch.where(mask, _leaky(raw, slope), NEG)
    pe = torch.where(mask, torch.exp(e - _slabs(m, row_blk)[:, :, None]), 0.0)
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
        nb * BLOCK, *vals.shape[2:])


def att_rowmax_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst,
                     slope: float) -> torch.Tensor:
    """Per-node max of the masked tile scores, −1e30 where none: the
    materialised (K, b, b) scores, a row max and a segment max."""
    nb = ssrc.shape[0] // BLOCK
    raw = _slabs(sdst, rows)[:, :, None] + _slabs(ssrc, cols)[:, None, :]
    tmax = torch.where(blocks != 0, _leaky(raw, slope), NEG).amax(dim=2)
    out = torch.full((nb, BLOCK), NEG, dtype=tmax.dtype, device=tmax.device)
    idx = rows.long()[:, None].expand_as(tmax)
    return out.scatter_reduce(0, idx, tmax, "amax",
                              include_self=True).reshape(-1)


def att_fwd_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, x,
                  slope: float) -> tuple:
    """``(num, den)`` from the materialised ``pe``."""
    nb = x.shape[0] // BLOCK
    _, _, pe = _tile_pe(blocks, ssrc, sdst, m, rows, cols, slope)
    num = _sum_by_block(torch.bmm(pe.to(x.dtype), _slabs(x, cols)), rows, nb)
    return num, _sum_by_block(pe.sum(dim=2), rows, nb)


def att_bwd_t_plain(plan: DynPlan, blocks, ssrc, sdst, m, g, x, dden,
                    slope: float, need_dx: bool = True,
                    need_dssrc: bool = True) -> tuple:
    """``(dx, dssrc)``, each None unless asked for, on the transpose plan:
    slot ``k`` reads forward tile ``t_sel[k]`` (rows block ``t_cols[k]``,
    columns block ``t_rows[k]``) scaled by ``t_scale[k]`` (0 for a coverage
    filler)."""
    nb = x.shape[0] // BLOCK
    mask, raw, pe = _tile_pe(blocks.index_select(0, plan.t_sel.long()), ssrc,
                             sdst, m, plan.t_cols, plan.t_rows, slope)
    sc = plan.t_scale.to(pe.dtype)[:, None, None]
    gs = _slabs(g, plan.t_cols)
    dx = dssrc = None
    if need_dx:
        dx = _sum_by_block(sc * torch.bmm(pe.transpose(1, 2).to(g.dtype), gs),
                           plan.t_rows, nb)
    if need_dssrc:
        d_raw = _d_raw(mask, raw, pe, gs.float(),
                       _slabs(x, plan.t_rows).float(),
                       _slabs(dden, plan.t_cols), slope)
        dssrc = _sum_by_block((sc * d_raw).sum(dim=1), plan.t_rows, nb)
    return dx, dssrc


def att_bwd_f_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g, x,
                    dden, slope: float) -> torch.Tensor:
    """``dsdst``: the row sums of ``d_raw`` on the forward walk."""
    rpart = att_scores_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                             dden, slope)[1]
    return _sum_by_block(rpart, rows, x.shape[0] // BLOCK)


def att_scores_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g, x,
                     dden, slope: float) -> tuple:
    """The score-gradient pass: ``(cpart, rpart)``, the column sums and the
    row sums of each forward tile's ``d_raw``, (K, b) each."""
    mask, raw, pe = _tile_pe(blocks, ssrc, sdst, m, rows, cols, slope)
    d_raw = _d_raw(mask, raw, pe, _slabs(g, rows).float(),
                   _slabs(x, cols).float(), _slabs(dden, rows), slope)
    return d_raw.sum(dim=1), d_raw.sum(dim=2)


def att_sums_plain(plan: DynPlan, cpart, rpart) -> tuple:
    """``(dssrc, dsdst)`` from the pass's partials: ``dssrc[c] = Σ
    scale·cpart[t_sel]`` over the transpose plan's slots of block ``c`` (a
    coverage filler, scale 0, adds nothing), ``dsdst[r]`` the row partials
    of block row ``r``'s tiles."""
    nb = plan.row_splits.shape[0] - 1
    sc = plan.t_scale[:, None]
    vals = torch.where(sc != 0, sc.to(cpart.dtype)
                       * cpart.index_select(0, plan.t_sel.long()), 0.0)
    rows = torch.repeat_interleave(
        torch.arange(nb, device=rpart.device),
        (plan.row_splits[1:] - plan.row_splits[:-1]).long())
    return (_sum_by_block(vals, plan.t_rows, nb),
            _sum_by_block(rpart, rows, nb))


def att_bwd_scores_plain(rows, cols, plan: DynPlan, blocks, ssrc, sdst, m, g,
                         x, dden, slope: float) -> tuple:
    """``(dssrc, dsdst)`` as the JAX package's two kernels give them: the
    column sums of ``d_raw`` on the transpose plan, its row sums on the
    forward walk."""
    return (att_bwd_t_plain(plan, blocks, ssrc, sdst, m, g, x, dden, slope,
                            need_dx=False)[1],
            att_bwd_f_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                            dden, slope))


# blocks, row_splits, cols, ssrc, sdst, out, num_row_blocks, slope, stream
_ROWMAX_ARGTYPES = ([ctypes.c_void_p] * 6
                    + [ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
# blocks, splits, sel, scale, cols, ssrc, sdst, m, x, out, den,
# num_row_blocks, feat, trans, slope, stream
_WALK_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 2
                  + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
# blocks, rows, cols, ssrc, sdst, m, dden, g, x, cpart, rpart, num_tiles,
# feat, slope, stream
_SCORES_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 2
                    + [ctypes.c_float, ctypes.c_void_p])
# cpart, rpart, row_splits, t_row_splits, t_sel, t_scale, dssrc, dsdst,
# num_row_blocks, stream
_SUMS_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_void_p]

_NULL = ctypes.c_void_p(None)


def _check(what: str, blocks, splits, vectors: dict, feats: dict = None,
           ints: dict = None) -> torch.device:
    """Validate the operands of a K7 launch (``splits`` is the walk's CSR
    over the block rows); returns their device."""
    n = next(iter(vectors.values())).shape[0]
    dev = blocks.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    kernels.require(splits, "splits", torch.int32, dev)
    if splits.shape[0] != n // BLOCK + 1:
        raise ValueError(f"{what}: {splits.shape[0]} splits for "
                         f"{n // BLOCK} block rows")
    kernels.require(blocks, "blocks", torch.float32, dev)
    if blocks.dim() != 3 or blocks.shape[1:] != (BLOCK, BLOCK):
        raise ValueError(f"{what}: blocks {tuple(blocks.shape)} must be "
                         f"(K, {BLOCK}, {BLOCK})")
    if blocks.data_ptr() % 16:
        raise ValueError(f"{what}: blocks must be 16-byte aligned")
    if n % BLOCK:
        raise ValueError(f"{what}: {n} nodes is not a multiple of {BLOCK}")
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


def att_rowmax(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
               blocks: torch.Tensor, ssrc: torch.Tensor, sdst: torch.Tensor,
               slope: float) -> torch.Tensor:
    """K7rm: per-node max of the masked tile scores, (n,) f32, −1e30 where
    a node has no tile in-edge: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor.  ``rows`` sorted, walked by
    ``plan.row_splits``."""
    if ssrc.device.type == "cpu":
        return att_rowmax_plain(rows, cols, plan, blocks, ssrc, sdst, slope)
    dev = _check("att_rowmax", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst), ints=dict(cols=cols))
    out = torch.empty_like(ssrc)
    launch = kernels.function("att_bsr", "fitgnn_att_rowmax",
                              _ROWMAX_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(plan.row_splits),
                    kernels.ptr(cols), kernels.ptr(ssrc), kernels.ptr(sdst),
                    kernels.ptr(out), plan.row_splits.shape[0] - 1,
                    float(slope), kernels.stream(dev))
    kernels.check(rc, "att_rowmax")
    att_rowmax.launches += 1
    return out


def _ptr(t):
    return _NULL if t is None else kernels.ptr(t)


def _launch_walk(what, dev, blocks, splits, sel, scale, cols, ssrc, sdst, m,
                 x, den, trans: bool, slope: float) -> torch.Tensor:
    """One launch of the tile walk (forward or the transpose plan's dx)."""
    out = torch.empty_like(x)
    launch = kernels.function("att_bsr", "fitgnn_att_walk", _WALK_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(splits), _ptr(sel),
                    _ptr(scale), kernels.ptr(cols), kernels.ptr(ssrc),
                    kernels.ptr(sdst), kernels.ptr(m), kernels.ptr(x),
                    kernels.ptr(out), _ptr(den), splits.shape[0] - 1,
                    x.shape[1], int(trans), float(slope), kernels.stream(dev))
    kernels.check(rc, what)
    return out


def _launch_scores(what, dev, blocks, rows, cols, ssrc, sdst, m, g, x, dden,
                   slope: float) -> tuple:
    """One launch of the score-gradient pass: ``(cpart, rpart)``, (K, b)
    each."""
    cpart, rpart = torch.empty((2, blocks.shape[0], BLOCK),
                               dtype=torch.float32, device=dev)
    launch = kernels.function("att_bsr", "fitgnn_att_scores",
                              _SCORES_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(rows), kernels.ptr(cols),
                    kernels.ptr(ssrc), kernels.ptr(sdst), kernels.ptr(m),
                    kernels.ptr(dden), kernels.ptr(g), kernels.ptr(x),
                    kernels.ptr(cpart), kernels.ptr(rpart), blocks.shape[0],
                    x.shape[1], float(slope), kernels.stream(dev))
    kernels.check(rc, what)
    return cpart, rpart


def att_fwd(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
            blocks: torch.Tensor, ssrc: torch.Tensor, sdst: torch.Tensor,
            m: torch.Tensor, x: torch.Tensor, slope: float) -> tuple:
    """K7f: ``(num (n, F), den (n,))`` of the tiles' softmax numerators
    worked out in the kernel, every row written: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return att_fwd_plain(rows, cols, plan, blocks, ssrc, sdst, m, x,
                             slope)
    dev = _check("att_fwd", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m), dict(x=x), dict(cols=cols))
    den = torch.empty_like(ssrc)
    num = _launch_walk("att_fwd", dev, blocks, plan.row_splits, None, None,
                       cols, ssrc, sdst, m, x, den, False, slope)
    att_fwd.launches += 1
    return num, den


def att_sums(plan: DynPlan, cpart: torch.Tensor,
             rpart: torch.Tensor) -> tuple:
    """K7's partial sums: ``(dssrc, dsdst)`` (n,) from the score-gradient
    pass's column and row partials (K, b), summed over the transpose plan's
    slots and the forward walk's tiles in order: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if cpart.device.type == "cpu":
        return att_sums_plain(plan, cpart, rpart)
    dev = cpart.device
    for name, t in (("cpart", cpart), ("rpart", rpart)):
        kernels.require(t, name, torch.float32, dev)
        if t.shape != cpart.shape or t.dim() != 2 or t.shape[1] != BLOCK:
            raise ValueError(f"att_sums: {name} {tuple(t.shape)} must be "
                             f"(K, {BLOCK}), as the other")
    for name in ("row_splits", "t_row_splits", "t_sel", "t_scale"):
        kernels.require(getattr(plan, name), name, torch.int32, dev)
    nb = plan.row_splits.shape[0] - 1
    if plan.t_row_splits.shape[0] != nb + 1:
        raise ValueError("att_sums: the plan's two walks cover "
                         "different block counts")
    dssrc, dsdst = torch.empty((2, nb * BLOCK), dtype=torch.float32,
                               device=dev)
    launch = kernels.function("att_bsr", "fitgnn_att_sums", _SUMS_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(cpart), kernels.ptr(rpart),
                    kernels.ptr(plan.row_splits),
                    kernels.ptr(plan.t_row_splits), kernels.ptr(plan.t_sel),
                    kernels.ptr(plan.t_scale), kernels.ptr(dssrc),
                    kernels.ptr(dsdst), nb, kernels.stream(dev))
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
    ``att_sums`` on its partials; the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return att_bwd_scores_plain(rows, cols, plan, blocks, ssrc, sdst, m,
                                    g, x, dden, slope)
    dev = _check("att_bwd_scores", blocks, plan.row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m, dden=dden), dict(g=g, x=x),
                 dict(rows=rows, cols=cols))
    if not rows.shape[0] == cols.shape[0] == blocks.shape[0]:
        raise ValueError(f"att_bwd_scores: {rows.shape[0]} rows and "
                         f"{cols.shape[0]} cols for {blocks.shape[0]} tiles")
    cpart, rpart = _launch_scores("att_bwd_scores", dev, blocks, rows, cols,
                                  ssrc, sdst, m, g, x, dden, slope)
    att_bwd_scores.launches += 1
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
    ``att_bwd_scores`` for ``dssrc``, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return att_bwd_t_plain(plan, blocks, ssrc, sdst, m, g, x, dden,
                               slope, need_dx, need_dssrc)
    dev = _check("att_bwd_t", blocks, plan.t_row_splits,
                 dict(ssrc=ssrc, sdst=sdst, m=m, dden=dden), dict(g=g, x=x),
                 dict(t_sel=plan.t_sel, t_scale=plan.t_scale,
                      t_cols=plan.t_cols))
    dx = dssrc = None
    if need_dx:
        dx = _launch_walk("att_bwd_t (dx)", dev, blocks, plan.t_row_splits,
                          plan.t_sel, plan.t_scale, plan.t_cols, ssrc, sdst,
                          m, g, None, True, slope)
        att_bwd_t.launches += 1
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
        return att_bwd_f_plain(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                               dden, slope)
    return att_bwd_scores(rows, cols, plan, blocks, ssrc, sdst, m, g, x,
                          dden, slope)[1]


att_rowmax.launches = 0
att_fwd.launches = 0
att_bwd_t.launches = 0
att_bwd_scores.launches = 0
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
