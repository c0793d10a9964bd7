"""Dynamic-tile BSR apply and its gradient (K4, K5).

``bsr_spmm_dyn(rows, cols, plan, blocks_dyn, x)`` computes
``out[rows[k]] += blocks_dyn[k] @ x[cols[k]]`` where the tile VALUES are a
runtime tensor (GAT's attention numerators ``exp(e − m)·mask``), and is
differentiable in ``blocks_dyn`` and ``x``, as the JAX package's
``ops/pallas/bsr_dynamic.py`` is:

* forward: K4 (``dyn_tiles``) over ``plan.row_splits``, tile k for slot
  k, applying only each tile row's non-zeros (``csrc/tile_sparse.cuh``,
  the rows orientation); the coverage fillers' zero values cost their read;
* ``dx``: K4 transposed (``dyn_tiles_t``) over the host-built transpose
  plan, reading ``blocks_dyn[t_sel[k]]ᵀ`` in place (no re-sorted tile
  copy) and applying only each tile column's non-zeros (the columns
  orientation); coverage-filler slots have ``t_scale`` 0 and add nothing;
* ``dblocks``: K5 (``dyn_grad_blocks``), ``dB[k] = g[rows[k]] @ x[cols[k]]ᵀ``,
  dense, on the tensor cores with f32 accuracy (TF32 operands split into
  a high and a low part); given the plan's ``live`` list, on its live
  quadrants alone and +0 on the others.

The tiles are (K, E, E) for any edge E that is a multiple of 128 (the JAX
package's ``build_hybrid(block=E, semantics="att_unit")``); every index
counts in E, and the plain versions and the wrappers read E from the
tiles' shape (K5, which has no tile operand, from its ``block``).  Above
128 the kernels take each tile as 128-wide quadrants (K4 and K4ᵀ walk
them, K5 gives each its own CTA); an edge off the multiples of 128 raises
``ValueError``.

Occupancy words: above 128 (up to 1024) a plan built with the mask's
occupancy words (``build_dyn_plan(..., words=bsr.quad_bits)``, as
``build_hybrid`` builds GAT's) carries them for both walks: ``words`` a
forward tile, ``t_words`` a transpose slot (its tile's word transposed, 0
on a filler), and ``live``, the list of their live quadrants (the grid of
K5 and of K7's score pass, ``ops/att_bsr.py``, which also runs K7f's
forward on ``words`` and K7bt's ``dx`` on ``t_words``).  K4 and K4ᵀ then
read and apply the live quadrants alone (``csrc/tile_sparse.cuh``
``walk_live``) and give the walk without words bit for bit, provided the
tile values are zero wherever the mask's quadrant is empty, as GAT's
``where(mask, exp(·), 0)`` is (``bsr_spmm_dyn`` states the contract).  The
plain versions of K4 and K4ᵀ read no words: they stay the JAX package's
dense product.  K5 runs a CTA only on each ``live`` quadrant and writes
the others as +0; its plain version takes the same ``live`` and zeroes
the same quadrants, and without it is the JAX package's dense product.

Each wrapper launches the hand-written kernel of ``csrc/bsr_dynamic.cu``
on CUDA tensors (it replaces ``fitgnn_tpu/ops/pallas/bsr_dynamic.py``'s
``_make_dyn_kernel`` and ``_dB_kernel``; the source note there says what
bounds each on an H100 and what the design does about it) and its plain
PyTorch version (``*_plain``, a batched matmul and ``index_add_``) on CPU
tensors.  ``<wrapper>.launches`` counts kernel launches.

bf16 activations (the JAX package's conv-stack ``dtype=bfloat16``: GAT's
``pe`` in the messages' type, bf16 ``x`` and cotangent): each wrapper
launches its kernel's bf16-activation form, counted in
``<wrapper>.launches_a``: K4a and K4ᵀa (C entry
``fitgnn_bsr_dyn_apply_a``: the same walks on bf16 tiles and a bf16
slab, each sum f32 and rounded to bf16 once) and K5a
(``fitgnn_dyn_grad_blocks_a``: one bf16 tensor-core pass, ``dB`` rounded
to bf16 once), at every edge and with the plan's words and live list as
the f32 forms.  The Pallas kernels round each tile's product into their
bf16 output block; K5's one F chunk (up to 512) rounds once as here
(``ROADMAP.md`` §3).  On the card the tiles must be in ``x``'s type (f32
with f32, bf16 with bf16), as GAT makes them; there is no fallback, and
a form that fails to build or launch raises.  The plain versions take
bf16 operands too: the products and sums in f32 on the widened values,
each output rounded to bf16 once, as the forms compute them.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK, MAX_WORD_QUADS, check_block
from fitgnn_tpu_torch.utils.device import dataclass_to


@dataclasses.dataclass
class DynPlan:
    """Walk order of a dynamic tile set: the forward's block-row CSR and
    the transpose's slot list (the JAX package's ``DynPlan`` arrays plus
    the CSR pointers a CUDA row walk needs)."""

    t_sel: torch.Tensor         # (Kt,) int32 forward tile read by each slot
    t_scale: torch.Tensor       # (Kt,) int32 1 = real tile, 0 = filler
    t_rows: torch.Tensor        # (Kt,) int32 out block id, sorted ascending
    t_cols: torch.Tensor        # (Kt,) int32 input block id
    t_row_splits: torch.Tensor  # (NB+1,) int32 slot range per out block
    row_splits: torch.Tensor    # (NB+1,) int32 forward tile range per row
    # occupancy words of the tiles' 128-wide quadrants (edge 256 to 1024),
    # or None: (K,) int64 a forward tile, bit i·nq + j for quadrant (i, j);
    # (Kt,) int64 a transpose slot, its tile's word with bit i·nq + j moved
    # to j·nq + i, 0 where t_scale is 0
    words: Optional[torch.Tensor] = None
    t_words: Optional[torch.Tensor] = None
    # the live quadrants of ``words``, or None where it is None: (L,) int32
    # ``k·nq² + i·nq + j`` for every set bit ``i·nq + j`` of ``words[k]``,
    # ascending (a tile's quadrants adjacent): the grid of K5 and of K7's
    # score pass
    live: Optional[torch.Tensor] = None

    def to(self, device) -> "DynPlan":
        return dataclass_to(self, device)


def transpose_words(words: np.ndarray, nq: int) -> np.ndarray:
    """Occupancy words of the transposed tiles: bit ``i·nq + j`` of each
    (int64) word moved to ``j·nq + i``."""
    u = np.asarray(words, dtype=np.int64).view(np.uint64)
    out = np.zeros_like(u)
    for i in range(nq):
        for j in range(nq):
            bit = (u >> np.uint64(i * nq + j)) & np.uint64(1)
            out |= bit << np.uint64(j * nq + i)
    return out.view(np.int64)


def build_dyn_plan(rows: np.ndarray, cols: np.ndarray, nb: int,
                   words=None, block: int = BLOCK) -> DynPlan:
    """Host-side: the transpose's slots sorted by their out block (the
    forward ``cols``), with zero-scale fillers so every out block is
    visited, exactly as the JAX package's ``build_dyn_plan``; plus the
    CSR pointers of both walks.  ``rows`` must be sorted ascending.

    ``words``: the (K,) int64 occupancy words of the (K, block, block)
    mask whose runtime values the walks will read (a ``BsrMatrix``'s
    ``quad_bits``), or None; given, the plan carries them (walked by K4
    and K7f), their transpose-slot form (``t_words``, walked by K4ᵀ and
    K7bt's ``dx``) and the list of their live quadrants (``live``), on
    which K5 and K7's score pass run their grids.  They are None without
    words (as at edge 128 and above 1024, where a ``BsrMatrix`` makes
    none); words at another edge raise ``ValueError``."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    order = np.argsort(cols, kind="stable")
    t_rows, t_cols, t_sel = cols[order], rows[order], order
    t_scale = np.ones(len(order), dtype=np.int64)
    missing = np.setdiff1d(np.arange(nb, dtype=np.int64), t_rows)
    if missing.size:
        t_rows = np.concatenate([t_rows, missing])
        t_cols = np.concatenate([t_cols, np.zeros(missing.size, np.int64)])
        t_sel = np.concatenate([t_sel, np.zeros(missing.size, np.int64)])
        t_scale = np.concatenate([t_scale, np.zeros(missing.size, np.int64)])
        res = np.argsort(t_rows, kind="stable")
        t_rows, t_cols = t_rows[res], t_cols[res]
        t_sel, t_scale = t_sel[res], t_scale[res]

    def i32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.int32))

    splits = np.arange(nb + 1)
    plan = DynPlan(t_sel=i32(t_sel), t_scale=i32(t_scale),
                   t_rows=i32(t_rows), t_cols=i32(t_cols),
                   t_row_splits=i32(np.searchsorted(t_rows, splits)),
                   row_splits=i32(np.searchsorted(rows, splits)))
    if words is not None:
        nq = block // BLOCK
        if block % BLOCK or not 1 < nq <= MAX_WORD_QUADS:
            raise ValueError(f"build_dyn_plan: occupancy words need a tile "
                             f"edge of 256 to {BLOCK * MAX_WORD_QUADS} in "
                             f"steps of {BLOCK}, not {block}")
        w = np.asarray(torch.as_tensor(words).cpu(), dtype=np.int64)
        if w.shape != rows.shape:
            raise ValueError(f"build_dyn_plan: words {w.shape} for "
                             f"{len(rows)} tiles")
        tw = np.where(t_scale != 0, transpose_words(w[t_sel], nq), 0)
        plan.words = torch.from_numpy(w.copy())
        plan.t_words = torch.from_numpy(tw.astype(np.int64))
        plan.live = i32(live_quadrants(w, nq))
    return plan


def live_quadrants(words: np.ndarray, nq: int) -> np.ndarray:
    """The set bits of (K,) int64 occupancy words as quadrant ids ``k·nq² +
    bit``, ascending; (L,) int64."""
    u = np.asarray(words, dtype=np.int64).view(np.uint64)
    if len(u) * nq * nq > np.iinfo(np.int32).max:
        raise ValueError(f"live_quadrants: {len(u)} tiles of {nq * nq} "
                         "quadrants overflow int32 ids")
    bits = (u[:, None] >> np.arange(nq * nq, dtype=np.uint64)) \
        & np.uint64(1)
    return np.flatnonzero(bits)


def _apply_plain(blocks, rows, cols, x, sel=None, scale=None,
                 trans=False) -> torch.Tensor:
    """``out[rows[k]] += scale[k]·(blocks[sel[k]] or its transpose) @
    x[cols[k]]``, from zero, at the tiles' edge: a batched matmul and
    ``index_add_``.  On bf16 ``x`` (K4a, K4ᵀa) the products and sums in
    f32 over the widened tiles and ``x``, the output rounded to bf16
    once."""
    if x.dtype == torch.bfloat16:
        return _apply_plain(blocks.float(), rows, cols, x.float(), sel, scale,
                            trans).to(torch.bfloat16)
    n, feat = x.shape
    e = blocks.shape[-1]
    a = blocks if sel is None else blocks.index_select(0, sel.long())
    if trans:
        a = a.transpose(1, 2)
    xb = x.reshape(n // e, e, feat).index_select(0, cols.long())
    prod = torch.bmm(a.to(x.dtype), xb)
    if scale is not None:
        prod = prod * scale.to(x.dtype)[:, None, None]
    out = torch.zeros((n // e, e, feat), dtype=x.dtype, device=x.device)
    return out.index_add_(0, rows.long(), prod).reshape(n, feat)


def dyn_tiles_plain(rows, cols, plan: DynPlan, blocks, x) -> torch.Tensor:
    """K4's plain version (K4a's on bf16 ``x``)."""
    return _apply_plain(blocks, rows, cols, x)


def dyn_tiles_t_plain(plan: DynPlan, blocks, g) -> torch.Tensor:
    """K4ᵀ's plain version (K4ᵀa's on bf16 ``g``)."""
    return _apply_plain(blocks, plan.t_rows, plan.t_cols, g, sel=plan.t_sel,
                        scale=plan.t_scale, trans=True)


def dyn_grad_blocks_plain(rows, cols, g, x, block: int = BLOCK,
                          live=None) -> torch.Tensor:
    """``dB[k] = g[rows[k]] @ x[cols[k]]ᵀ`` over (block, F) slabs; given
    ``live`` (quadrant ids ``k·nq² + i·nq + j``), +0 on every 128-wide
    quadrant it does not list.  On bf16 ``g`` and ``x`` (K5a) the products
    and sums in f32 over the widened values, ``dB`` rounded to bf16
    once."""
    if x.dtype == torch.bfloat16:
        return dyn_grad_blocks_plain(rows, cols, g.float(), x.float(), block,
                                     live).to(torch.bfloat16)
    n, feat = x.shape
    gb = g.reshape(n // block, block, feat).index_select(0, rows.long())
    xb = x.reshape(n // block, block, feat).index_select(0, cols.long())
    out = torch.bmm(gb, xb.transpose(1, 2))
    if live is None:
        return out
    k, nq = out.shape[0], block // BLOCK
    keep = torch.zeros(k * nq * nq, dtype=torch.bool, device=out.device)
    keep[live.long()] = True
    return torch.where(keep.reshape(k, nq, 1, nq, 1),
                       out.reshape(k, nq, BLOCK, nq, BLOCK),
                       0.0).reshape(out.shape)


# blocks, row_splits, sel, scale, cols, words, x, out, num_row_blocks,
# feat, block, trans, stream
_APPLY_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3
                   + [ctypes.c_int, ctypes.c_void_p])
# rows, cols, live, g, x, dB, num_tiles, num_live, feat, block, stream
_GRAD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [
    ctypes.c_void_p]


def _check_operands(what: str, blocks, x, block: int,
                    *ints) -> torch.device:
    """Validate a launch's operands at tile edge ``block``: ``x`` (and the
    tiles) f32, or bf16 for the bf16-activation forms; returns their
    device."""
    check_block(block)
    if x.dim() != 2 or x.shape[0] % block:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"(a multiple of {block}, F)")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", x.dtype, dev)
    if blocks is not None:
        # the tiles in the activations' type, as GAT makes pe
        kernels.require(blocks, "blocks", x.dtype, dev)
        if blocks.dim() != 3 or blocks.shape[1:] != (block, block):
            raise ValueError(f"{what}: blocks {tuple(blocks.shape)} must be "
                             f"(K, {block}, {block})")
        if blocks.data_ptr() % 16:
            raise ValueError(f"{what}: blocks must be 16-byte aligned")
    for name, t in ints:
        kernels.require(t, name, torch.int32, dev)
    return dev


def _launch_apply(what, blocks, row_splits, sel, scale, cols, words, x,
                  trans: bool) -> torch.Tensor:
    """Launch K4 (K4ᵀ under ``trans``) on a fresh output; ``words`` the
    slots' occupancy words or None (the walk of every quadrant).  Given
    words, a tile edge the walk of the live quadrants does not take (128,
    above 1024) raises: there is no fallback to the walk without them."""
    ints = [("row_splits", row_splits), ("cols", cols)]
    if sel is not None:
        ints += [("sel", sel), ("scale", scale)]
    if blocks.dim() != 3:
        raise ValueError(f"{what}: blocks {tuple(blocks.shape)} must be "
                         "(K, E, E)")
    block = blocks.shape[-1]
    dev = _check_operands(what, blocks, x, block, *ints)
    nb = x.shape[0] // block
    if row_splits.shape[0] != nb + 1:
        raise ValueError(f"{what}: row_splits has {row_splits.shape[0]} "
                         f"entries for {nb} block rows")
    if words is not None:
        kernels.require(words, "words", torch.int64, dev)
        if words.shape != cols.shape:
            raise ValueError(f"{what}: words {tuple(words.shape)} for "
                             f"{cols.shape[0]} slots")
    out = torch.empty_like(x)
    launch = kernels.function("bsr_dynamic", "fitgnn_bsr_dyn_apply" + (
        "_a" if x.dtype == torch.bfloat16 else ""), _APPLY_ARGTYPES)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(row_splits),
                    null if sel is None else kernels.ptr(sel),
                    null if scale is None else kernels.ptr(scale),
                    kernels.ptr(cols),
                    null if words is None else kernels.ptr(words),
                    kernels.ptr(x), kernels.ptr(out),
                    nb, x.shape[1], block, int(trans), kernels.stream(dev))
    kernels.check(rc, what)
    return out


def _count(fn, x: torch.Tensor) -> None:
    """One launch of wrapper ``fn``: its bf16-activation form's
    (``launches_a``) on bf16 ``x``, else its f32 form's (``launches``)."""
    if x.dtype == torch.bfloat16:
        fn.launches_a += 1
    else:
        fn.launches += 1


def dyn_tiles(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
              blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4 forward, ``out[rows[k]] += blocks[k] @ x[cols[k]]`` from zero
    (``rows`` sorted; the kernel walks ``plan.row_splits``, and with
    ``plan.words`` the live quadrants alone): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor.  bf16 ``x`` with bf16
    ``blocks`` (GAT's ``pe`` in the messages' type) launches K4a."""
    kernels.narrow("dyn_tiles", x)
    if x.device.type == "cpu":
        check_block(blocks.shape[-1])
        return dyn_tiles_plain(rows, cols, plan, blocks, x)
    out = _launch_apply("dyn_tiles", blocks, plan.row_splits, None, None,
                        cols, plan.words, x, trans=False)
    _count(dyn_tiles, x)
    return out


def dyn_tiles_t(plan: DynPlan, blocks: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """K4 transposed, ``out[t_rows[k]] += t_scale[k]·blocks[t_sel[k]]ᵀ @
    g[t_cols[k]]`` from zero (with ``plan.t_words`` the live quadrants
    alone): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor; bf16 ``g`` with bf16 ``blocks`` launches K4ᵀa."""
    kernels.narrow("dyn_tiles_t", g)
    if g.device.type == "cpu":
        check_block(blocks.shape[-1])
        return dyn_tiles_t_plain(plan, blocks, g)
    out = _launch_apply("dyn_tiles_t", blocks, plan.t_row_splits,
                        plan.t_sel, plan.t_scale, plan.t_cols, plan.t_words,
                        g, trans=True)
    _count(dyn_tiles_t, g)
    return out


def dyn_grad_blocks(rows: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
                    x: torch.Tensor, block: int = BLOCK,
                    live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5, ``dB[k] = g[rows[k]] @ x[cols[k]]ᵀ`` for every tile (fillers
    included), (K, block, block), ``block`` the tile edge: the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor.  ``live``: the
    plan's (L,) int32 list of quadrant ids ``k·nq² + i·nq + j``, ascending
    (``DynPlan.live``), or None; given, only those quadrants' products are
    computed and every other quadrant is +0 (the kernel launches no
    product there).  A live list at edge 128 (or above 1024) raises on the
    card: there is no fallback to the full grid.  bf16 ``g`` and ``x``
    launch K5a, whose ``dB`` is bf16 (rounded once from the f32 sums), as
    the JAX kernel's ``out_dtype=blocks_dyn.dtype``."""
    if g.shape != x.shape:
        raise ValueError(f"dyn_grad_blocks: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} differ")
    kernels.narrow("dyn_grad_blocks", x)
    if x.device.type == "cpu":
        check_block(block)
        return dyn_grad_blocks_plain(rows, cols, g, x, block, live)
    dev = _check_operands("dyn_grad_blocks", None, x, block, ("rows", rows),
                          ("cols", cols))
    kernels.require(g, "g", x.dtype, dev)
    if live is not None:
        kernels.require(live, "live", torch.int32, dev)
        if live.dim() != 1:
            raise ValueError(f"dyn_grad_blocks: live {tuple(live.shape)} "
                             "must be (L,)")
    k = rows.shape[0]
    out = torch.empty((k, block, block), dtype=x.dtype, device=dev)
    launch = kernels.function("bsr_dynamic", "fitgnn_dyn_grad_blocks" + (
        "_a" if x.dtype == torch.bfloat16 else ""), _GRAD_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(rows), kernels.ptr(cols),
                    ctypes.c_void_p(None) if live is None
                    else kernels.ptr(live), kernels.ptr(g), kernels.ptr(x),
                    kernels.ptr(out), k,
                    0 if live is None else live.shape[0], x.shape[1], block,
                    kernels.stream(dev))
    kernels.check(rc, "dyn_grad_blocks")
    _count(dyn_grad_blocks, x)
    return out


for _fn in (dyn_tiles, dyn_tiles_t, dyn_grad_blocks):
    _fn.launches = _fn.launches_a = 0


class _BsrSpmmDyn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rows, cols, plan, blocks_dyn, x):
        ctx.plan = plan
        ctx.save_for_backward(rows, cols, blocks_dyn, x)
        return dyn_tiles(rows, cols, plan, blocks_dyn, x)

    @staticmethod
    def backward(ctx, g):
        rows, cols, blocks_dyn, x = ctx.saved_tensors
        g = g.contiguous()
        dblocks = dx = None
        if ctx.needs_input_grad[3]:
            # K5a's dB is bf16 already; K5's f32 dB takes the tiles' type
            dblocks = dyn_grad_blocks(rows, cols, g, x,
                                      blocks_dyn.shape[-1],
                                      ctx.plan.live).to(blocks_dyn.dtype)
        if ctx.needs_input_grad[4]:
            dx = dyn_tiles_t(ctx.plan, blocks_dyn, g)
        return None, None, None, dblocks, dx


def bsr_spmm_dyn(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
                 blocks_dyn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_k scatter(rows[k], blocks_dyn[k] @ x[cols[k]])`` over (K, E, E)
    tiles, differentiable in ``blocks_dyn`` and ``x``.  ``rows`` must be
    sorted ascending and cover every block row (the static BSR's coverage
    fillers do; their dynamic values must be zero); ``plan =
    build_dyn_plan(rows, cols, nb[, words, block])``, nb counting block
    rows of E.  A backward launches only what its inputs need: no K4ᵀ when
    ``x`` needs no gradient.

    With occupancy words in the plan (E of 256 to 1024; ``build_hybrid``
    gives GAT's plan its ``att_unit`` mask's ``quad_bits``), the contract
    is that ``blocks_dyn`` is zero on every 128-wide quadrant whose bit is
    clear, as ``where(mask, exp(·), 0)`` is on the mask's empty quadrants.
    K4 and K4ᵀ then skip those quadrants unread.  On CUDA tensors the
    result departs from the dense product (the plain versions, the JAX
    package's ``bsr_spmm_dyn``) only off that contract: a non-zero value
    in a cleared quadrant is dropped, and an inf or NaN in ``x`` (or the
    cotangent) that only such quadrants reach stays out of the output.
    K5 (``dblocks``) then runs on the plan's ``live`` quadrants alone, on
    any device: ``dblocks`` is +0 on every quadrant whose bit is clear,
    where the dense gradient (the JAX package's) is ``g·xᵀ``.  GAT's
    ``where(mask, exp(·), 0)`` reads ``dblocks`` only under the mask, so no
    gradient it returns sees the difference (``ROADMAP.md`` §3).  Without
    words every tile's dense gradient is computed."""
    return _BsrSpmmDyn.apply(rows, cols, plan, blocks_dyn.contiguous(),
                             x.contiguous())
