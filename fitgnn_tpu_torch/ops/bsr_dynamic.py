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
  a high and a low part).

Each wrapper launches the hand-written kernel of ``csrc/bsr_dynamic.cu``
on CUDA tensors (it replaces ``fitgnn_tpu/ops/pallas/bsr_dynamic.py``'s
``_make_dyn_kernel`` and ``_dB_kernel``; the source note there says what
bounds each on an H100 and what the design does about it) and its plain
PyTorch version (``*_plain``, a batched matmul and ``index_add_``) on CPU
tensors.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.ops.bsr_spmm import BLOCK
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

    def to(self, device) -> "DynPlan":
        return dataclass_to(self, device)


def build_dyn_plan(rows: np.ndarray, cols: np.ndarray, nb: int) -> DynPlan:
    """Host-side: the transpose's slots sorted by their out block (the
    forward ``cols``), with zero-scale fillers so every out block is
    visited, exactly as the JAX package's ``build_dyn_plan``; plus the
    CSR pointers of both walks.  ``rows`` must be sorted ascending."""
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
    return DynPlan(t_sel=i32(t_sel), t_scale=i32(t_scale),
                   t_rows=i32(t_rows), t_cols=i32(t_cols),
                   t_row_splits=i32(np.searchsorted(t_rows, splits)),
                   row_splits=i32(np.searchsorted(rows, splits)))


def _apply_plain(blocks, rows, cols, x, sel=None, scale=None,
                 trans=False) -> torch.Tensor:
    """``out[rows[k]] += scale[k]·(blocks[sel[k]] or its transpose) @
    x[cols[k]]``, from zero: a batched matmul and ``index_add_``."""
    n, feat = x.shape
    a = blocks if sel is None else blocks.index_select(0, sel.long())
    if trans:
        a = a.transpose(1, 2)
    xb = x.reshape(n // BLOCK, BLOCK, feat).index_select(0, cols.long())
    prod = torch.bmm(a.to(x.dtype), xb)
    if scale is not None:
        prod = prod * scale.to(x.dtype)[:, None, None]
    out = torch.zeros((n // BLOCK, BLOCK, feat), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, rows.long(), prod).reshape(n, feat)


def dyn_tiles_plain(rows, cols, plan: DynPlan, blocks, x) -> torch.Tensor:
    return _apply_plain(blocks, rows, cols, x)


def dyn_tiles_t_plain(plan: DynPlan, blocks, g) -> torch.Tensor:
    return _apply_plain(blocks, plan.t_rows, plan.t_cols, g, sel=plan.t_sel,
                        scale=plan.t_scale, trans=True)


def dyn_grad_blocks_plain(rows, cols, g, x) -> torch.Tensor:
    """``dB[k] = g[rows[k]] @ x[cols[k]]ᵀ`` over (BLOCK, F) slabs."""
    n, feat = x.shape
    gb = g.reshape(n // BLOCK, BLOCK, feat).index_select(0, rows.long())
    xb = x.reshape(n // BLOCK, BLOCK, feat).index_select(0, cols.long())
    return torch.bmm(gb, xb.transpose(1, 2))


# blocks, row_splits, sel, scale, cols, x, out, num_row_blocks, feat,
# trans, stream
_APPLY_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 2
                   + [ctypes.c_int, ctypes.c_void_p])
# rows, cols, g, x, dB, num_tiles, feat, stream
_GRAD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
    ctypes.c_void_p]


def _check_operands(what: str, blocks, x, *ints) -> torch.device:
    if x.dim() != 2 or x.shape[0] % BLOCK:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"(a multiple of {BLOCK}, F)")
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    if blocks is not None:
        kernels.require(blocks, "blocks", torch.float32, dev)
        if blocks.dim() != 3 or blocks.shape[1:] != (BLOCK, BLOCK):
            raise ValueError(f"{what}: blocks {tuple(blocks.shape)} must be "
                             f"(K, {BLOCK}, {BLOCK})")
        if blocks.data_ptr() % 16:
            raise ValueError(f"{what}: blocks must be 16-byte aligned")
    for name, t in ints:
        kernels.require(t, name, torch.int32, dev)
    return dev


def _launch_apply(what, blocks, row_splits, sel, scale, cols, x,
                  trans: bool) -> torch.Tensor:
    ints = [("row_splits", row_splits), ("cols", cols)]
    if sel is not None:
        ints += [("sel", sel), ("scale", scale)]
    dev = _check_operands(what, blocks, x, *ints)
    nb = x.shape[0] // BLOCK
    if row_splits.shape[0] != nb + 1:
        raise ValueError(f"{what}: row_splits has {row_splits.shape[0]} "
                         f"entries for {nb} block rows")
    out = torch.empty_like(x)
    launch = kernels.function("bsr_dynamic", "fitgnn_bsr_dyn_apply",
                              _APPLY_ARGTYPES)
    null = ctypes.c_void_p(None)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(row_splits),
                    null if sel is None else kernels.ptr(sel),
                    null if scale is None else kernels.ptr(scale),
                    kernels.ptr(cols), kernels.ptr(x), kernels.ptr(out),
                    nb, x.shape[1], int(trans), kernels.stream(dev))
    kernels.check(rc, what)
    return out


def dyn_tiles(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
              blocks: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4 forward, ``out[rows[k]] += blocks[k] @ x[cols[k]]`` from zero
    (``rows`` sorted; the kernel walks ``plan.row_splits``): the CUDA
    kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return dyn_tiles_plain(rows, cols, plan, blocks, x)
    out = _launch_apply("dyn_tiles", blocks, plan.row_splits, None, None,
                        cols, x, trans=False)
    dyn_tiles.launches += 1
    return out


def dyn_tiles_t(plan: DynPlan, blocks: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """K4 transposed, ``out[t_rows[k]] += t_scale[k]·blocks[t_sel[k]]ᵀ @
    g[t_cols[k]]`` from zero: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if g.device.type == "cpu":
        return dyn_tiles_t_plain(plan, blocks, g)
    out = _launch_apply("dyn_tiles_t", blocks, plan.t_row_splits,
                        plan.t_sel, plan.t_scale, plan.t_cols, g,
                        trans=True)
    dyn_tiles_t.launches += 1
    return out


def dyn_grad_blocks(rows: torch.Tensor, cols: torch.Tensor, g: torch.Tensor,
                    x: torch.Tensor) -> torch.Tensor:
    """K5, ``dB[k] = g[rows[k]] @ x[cols[k]]ᵀ`` for every tile (fillers
    included), (K, BLOCK, BLOCK): the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if g.shape != x.shape:
        raise ValueError(f"dyn_grad_blocks: g {tuple(g.shape)} and x "
                         f"{tuple(x.shape)} differ")
    if x.device.type == "cpu":
        return dyn_grad_blocks_plain(rows, cols, g, x)
    dev = _check_operands("dyn_grad_blocks", None, x, ("rows", rows),
                          ("cols", cols))
    kernels.require(g, "g", torch.float32, dev)
    k = rows.shape[0]
    out = torch.empty((k, BLOCK, BLOCK), dtype=x.dtype, device=dev)
    launch = kernels.function("bsr_dynamic", "fitgnn_dyn_grad_blocks",
                              _GRAD_ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(rows), kernels.ptr(cols), kernels.ptr(g),
                    kernels.ptr(x), kernels.ptr(out), k, x.shape[1],
                    kernels.stream(dev))
    kernels.check(rc, "dyn_grad_blocks")
    dyn_grad_blocks.launches += 1
    return out


dyn_tiles.launches = 0
dyn_tiles_t.launches = 0
dyn_grad_blocks.launches = 0


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
            dblocks = dyn_grad_blocks(rows, cols, g, x).to(blocks_dyn.dtype)
        if ctx.needs_input_grad[4]:
            dx = dyn_tiles_t(ctx.plan, blocks_dyn, g)
        return None, None, None, dblocks, dx


def bsr_spmm_dyn(rows: torch.Tensor, cols: torch.Tensor, plan: DynPlan,
                 blocks_dyn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``Σ_k scatter(rows[k], blocks_dyn[k] @ x[cols[k]])``, differentiable
    in ``blocks_dyn`` and ``x``.  ``rows`` must be sorted ascending and
    cover every block row (the static BSR's coverage fillers do; their
    dynamic values must be zero); ``plan = build_dyn_plan(rows, cols,
    nb)``.  A backward launches only what its inputs need: no K4ᵀ when
    ``x`` needs no gradient."""
    return _BsrSpmmDyn.apply(rows, cols, plan, blocks_dyn.contiguous(),
                             x.contiguous())
