"""Block-sparse (BCSR) SpMM: the tile walks K1, K2, K9 and K10.

Community-reordered adjacency is block-sparse: most edges land in a few
dense 128×128 tiles.  ``blocks[k]`` is tile ``(rows[k], cols[k])`` and adds
``A_k · X[cols[k]]`` into block-row ``rows[k]``.  ``build_bsr`` makes the
JAX package's three layouts: the grid-walk layout (every block row holds at
least one tile, zero coverage fillers where it had none), the group-padded
layout (``group > 1``: every row's run zero-padded to a multiple of
``group``) and the row-walk layout (``rowwalk``: no fillers).

* ``bsr_spmm_acc(b, x, init)`` = ``init + A·x``: K1 on the grid-walk
  layout, ``init + bsr_spmm(...)`` on the others, as the JAX package's
  ``bsr_spmm_acc_raw``.
* ``bsr_spmm(b, x)`` = ``A·x``, differentiable in ``x``: dispatched by the
  layout as the JAX package's ``_fwd_dispatch``, to K10 (row walk,
  ``bsr_spmm_rowwalk``), K9 (grouped, ``bsr_spmm_grouped``) or K2
  (``bsr_spmm_fwd``); its backward runs the same dispatch on
  ``b.transpose``.

Each of the four wrappers launches its hand-written kernel through its C
entry in ``csrc/bsr_spmm.cu`` on a CUDA tensor (they replace the TPU
kernels ``_kernel_acc``, ``_kernel``, ``_make_grouped_kernel`` and
``_rowwalk_kernel`` of ``fitgnn_tpu/ops/pallas/bsr_spmm.py``).  All four
launch one kernel, the walk of each tile's non-zeros in
``csrc/tile_sparse.cuh``, which starts from ``init`` for K1 and from zero
for the others; the source notes say what bounds it on an H100 and what
the design does about it.  On a CPU tensor each runs the plain version
(``bsr_spmm_acc_plain``, ``bsr_spmm_plain``: a batched matmul over the
gathered X slabs, then ``index_add_`` over block rows).  Each has its own
``launches`` count.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.utils.device import dataclass_to

BLOCK = 128  # node-block edge length: one dense tile


@dataclasses.dataclass
class BsrMatrix:
    """Dense-block BCSR adjacency. ``blocks[k]`` is tile (rows[k], cols[k])."""

    blocks: torch.Tensor        # (K, BLOCK, BLOCK) f32 tile values
    rows: torch.Tensor          # (K,) int32 block-row id, sorted ascending
    cols: torch.Tensor          # (K,) int32 block-col id
    num_row_blocks: int
    num_col_blocks: int
    transpose: Optional["BsrMatrix"] = None   # Aᵀ for the backward pass
    row_splits: Optional[torch.Tensor] = None  # (NB+1,) int32 CSR pointers
    rowwalk: bool = False       # row-walk layout: no coverage fillers (K10)
    group: int = 1              # every row's run padded to a multiple (K9)

    @property
    def nnz_blocks(self) -> int:
        return self.blocks.shape[0]

    def to(self, device) -> "BsrMatrix":
        return dataclass_to(self, device)


def build_bsr(senders: np.ndarray, receivers: np.ndarray, weight: np.ndarray,
              num_nodes_padded: int, block: int = BLOCK,
              with_transpose: bool = True, *, tile_dtype=None,
              rowwalk: bool = False, group: int = 1,
              einsum: bool = False) -> BsrMatrix:
    """Host-side BCSR construction from a COO edge list (numpy): the same
    blocks, rows, cols and row_splits as the JAX package's ``build_bsr``
    with the same ``rowwalk`` and ``group``, and a transpose built with the
    same flags.  Tiles are f32 and 128 wide; ``block != 128``, bf16
    ``tile_dtype`` and ``einsum`` are not ported (ROADMAP.md §1 item 2).

    ``num_nodes_padded`` must be a multiple of 128.  Edges pointing at
    padding slots are harmless as long as their weight is 0."""
    if block != BLOCK or tile_dtype is not None or einsum:
        raise NotImplementedError(
            "build_bsr: block != 128, bf16 tile_dtype and einsum are not "
            "ported yet (ROADMAP.md §1 item 2)")
    if group < 1:
        raise ValueError(f"build_bsr: group must be >= 1, got {group}")
    dtype = np.float32
    if num_nodes_padded % block:
        raise ValueError(f"num_nodes_padded={num_nodes_padded} is not a "
                         f"multiple of block={block}")
    nb = num_nodes_padded // block
    brow = receivers // block
    bcol = senders // block
    key = brow.astype(np.int64) * nb + bcol
    uniq, inv = np.unique(key, return_inverse=True)
    k = uniq.shape[0]
    blocks = np.zeros((max(k, 1), block, block), dtype=dtype)
    np.add.at(blocks, (inv, receivers % block, senders % block),
              weight.astype(dtype))
    rows = (uniq // nb).astype(np.int32)
    cols = (uniq % nb).astype(np.int32)
    if k == 0:
        rows = np.zeros(1, dtype=np.int32)
        cols = np.zeros(1, dtype=np.int32)
    if not rowwalk:
        # coverage fillers: the TPU grid leaves an unvisited out block
        # uninitialized, so every block-row gets ≥1 (zero) tile.  The CUDA
        # walks write every row themselves; the fillers stay for parity and
        # cost one zero tile each.  The row walk has none.
        missing = np.setdiff1d(np.arange(nb, dtype=np.int32), rows)
        if missing.size:
            blocks = np.concatenate(
                [blocks, np.zeros((missing.size, block, block), dtype=dtype)])
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros(missing.size, np.int32)])
            order = np.argsort(rows, kind="stable")
            blocks, rows, cols = blocks[order], rows[order], cols[order]
    if group > 1 and not rowwalk:
        # every row's run zero-padded to a multiple of ``group``; the pads
        # reuse the row's first column id (a zero product on a real slab)
        counts = np.bincount(rows, minlength=nb)      # ≥1 per row (fillers)
        padded = -(-counts // group) * group
        starts_new = np.concatenate(([0], np.cumsum(padded)))[:-1]
        starts_old = np.concatenate(([0], np.cumsum(counts)))[:-1]
        new_blocks = np.zeros((int(padded.sum()), block, block), dtype=dtype)
        new_rows = np.repeat(np.arange(nb, dtype=np.int32), padded)
        new_cols = np.repeat(cols[starts_old], padded)
        idx = starts_new[rows] + (np.arange(rows.size) - starts_old[rows])
        new_blocks[idx] = blocks
        new_cols[idx] = cols
        blocks, rows, cols = new_blocks, new_rows, new_cols

    t = None
    if with_transpose:
        t = build_bsr(receivers, senders, weight, num_nodes_padded,
                      with_transpose=False, rowwalk=rowwalk, group=group)
    row_splits = np.searchsorted(rows, np.arange(nb + 1)).astype(np.int32)
    return BsrMatrix(
        blocks=torch.from_numpy(blocks), rows=torch.from_numpy(rows),
        cols=torch.from_numpy(cols), num_row_blocks=nb, num_col_blocks=nb,
        transpose=t, row_splits=torch.from_numpy(row_splits),
        rowwalk=rowwalk, group=group)


def _tile_sum(b: BsrMatrix, x: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """``out += A·x`` in place on an (N_pad, F) ``out``: gather the (K,
    block, F) X slabs, one batched matmul, ``index_add_`` over block rows."""
    n, feat = x.shape
    xb = x.reshape(b.num_col_blocks, BLOCK, feat)
    prod = torch.bmm(b.blocks.to(x.dtype), xb.index_select(0, b.cols.long()))
    return out.reshape(b.num_row_blocks, BLOCK, feat).index_add_(
        0, b.rows.long(), prod).reshape(n, feat)


def bsr_spmm_acc_plain(b: BsrMatrix, x: torch.Tensor,
                       init: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``init + A·x`` (K1)."""
    return _tile_sum(b, x, init.clone())


def bsr_spmm_plain(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A·x`` on any of the three layouts (K2, K9, K10)."""
    return _tile_sum(b, x, torch.zeros_like(x))


def _operands(b: BsrMatrix, x: torch.Tensor, what: str,
              init: Optional[torch.Tensor] = None) -> Optional[torch.device]:
    """Validate a walk's operands; the CUDA device, or None on the CPU."""
    if x.dim() != 2 or x.shape[0] != b.num_row_blocks * BLOCK:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"({b.num_row_blocks * BLOCK}, F)")
    if x.device.type == "cpu":
        return None
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    if init is not None:
        kernels.require(init, "init", torch.float32, dev)
    kernels.require(b.blocks, "blocks", torch.float32, dev)
    kernels.require(b.row_splits, "row_splits", torch.int32, dev)
    kernels.require(b.cols, "cols", torch.int32, dev)
    if b.blocks.data_ptr() % 16:
        raise ValueError(f"{what}: blocks must be 16-byte aligned")
    return dev


# blocks, row_splits, cols, x, [init,] out, num_row_blocks, feat, stream
_PTR, _I64 = ctypes.c_void_p, ctypes.c_int64
_ARGS_ACC = [_PTR] * 6 + [_I64] * 2 + [_PTR]
_ARGS_FWD = [_PTR] * 5 + [_I64] * 2 + [_PTR]


def _launch(b: BsrMatrix, x: torch.Tensor, dev: torch.device, what: str,
            name: str, argtypes: list, ins: list) -> torch.Tensor:
    """Launch C entry ``name`` on the tile structure, the input tensors
    ``ins`` and a fresh output, then the sizes."""
    out = torch.empty_like(x)
    launch = kernels.function("bsr_spmm", name, argtypes)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(b.blocks), kernels.ptr(b.row_splits),
                    kernels.ptr(b.cols), *(kernels.ptr(t) for t in ins),
                    kernels.ptr(out), b.num_row_blocks, x.shape[1],
                    kernels.stream(dev))
    kernels.check(rc, what)
    return out


def bsr_spmm_acc(b: BsrMatrix, x: torch.Tensor,
                 init: torch.Tensor) -> torch.Tensor:
    """``init + A·x`` for (N_pad, F) ``x`` and ``init``.  On the grid-walk
    layout K1 (the walk started from ``init`` on a CUDA tensor, the plain
    version on a CPU tensor); on the row-walk and grouped layouts
    ``init + bsr_spmm_raw``, so that K10 or K9 run.  Forward only: the
    hybrid operator's autograd Function runs it on ``b.transpose`` for the
    backward."""
    if init.shape != x.shape:
        raise ValueError(f"bsr_spmm_acc: x {tuple(x.shape)} and init "
                         f"{tuple(init.shape)} differ")
    if b.rowwalk or b.group > 1:
        return init + bsr_spmm_raw(b, x)
    dev = _operands(b, x, "bsr_spmm_acc", init)
    if dev is None:
        return bsr_spmm_acc_plain(b, x, init)
    out = _launch(b, x, dev, "bsr_spmm_acc", "fitgnn_bsr_spmm_acc",
                  _ARGS_ACC, [x, init])
    bsr_spmm_acc.launches += 1
    return out


def bsr_spmm_fwd(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K2: ``A·x`` from zero on the grid-walk layout, by the walk of each
    tile's non-zeros; a coverage filler costs only its read."""
    if b.rowwalk or b.group > 1:
        raise ValueError("bsr_spmm_fwd: K2 walks the grid-walk layout, got "
                         f"rowwalk={b.rowwalk} group={b.group}")
    dev = _operands(b, x, "bsr_spmm_fwd")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_fwd", "fitgnn_bsr_spmm", _ARGS_FWD,
                  [x])
    bsr_spmm_fwd.launches += 1
    return out


def bsr_spmm_grouped(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K9: ``A·x`` from zero on the group-padded layout.  The kernel walks
    each tile's non-zeros and the padded run as a plain run: a zero pad
    costs only its read, and the group is not passed."""
    if b.rowwalk or b.group < 2:
        raise ValueError("bsr_spmm_grouped: K9 walks the group-padded "
                         f"layout, got rowwalk={b.rowwalk} group={b.group}")
    dev = _operands(b, x, "bsr_spmm_grouped")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_grouped", "fitgnn_bsr_spmm_grouped",
                  _ARGS_FWD, [x])
    bsr_spmm_grouped.launches += 1
    return out


def bsr_spmm_rowwalk(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """K10: ``A·x`` from zero on the row-walk layout, by the walk of each
    tile's non-zeros; a block row without tiles comes out zero."""
    if not b.rowwalk:
        raise ValueError("bsr_spmm_rowwalk: K10 walks the row-walk layout")
    dev = _operands(b, x, "bsr_spmm_rowwalk")
    if dev is None:
        return bsr_spmm_plain(b, x)
    out = _launch(b, x, dev, "bsr_spmm_rowwalk", "fitgnn_bsr_spmm_rowwalk",
                  _ARGS_FWD, [x])
    bsr_spmm_rowwalk.launches += 1
    return out


for _fn in (bsr_spmm_acc, bsr_spmm_fwd, bsr_spmm_grouped, bsr_spmm_rowwalk):
    _fn.launches = 0


def bsr_spmm_raw(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` by the layout, as the JAX package's ``_fwd_dispatch``: K10
    for the row walk, K9 for ``group > 1``, K2 otherwise.  No autograd."""
    if b.rowwalk:
        return bsr_spmm_rowwalk(b, x)
    if b.group > 1:
        return bsr_spmm_grouped(b, x)
    return bsr_spmm_fwd(b, x)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, b, x):
        ctx.b = b
        return bsr_spmm_raw(b, x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        return None, bsr_spmm_raw(ctx.b.transpose, g.contiguous())


def bsr_spmm(b: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` with ``A`` in BCSR form, (N_pad, F) → (N_pad, F),
    differentiable in ``x`` (the backward needs ``b.transpose``, built with
    the same layout flags)."""
    if b.transpose is None and x.requires_grad and torch.is_grad_enabled():
        raise ValueError("bsr_spmm: the gradient needs "
                         "build_bsr(with_transpose=True)")
    return _BsrSpmm.apply(b, x.contiguous())
