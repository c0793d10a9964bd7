"""Block-sparse (BCSR) SpMM with the hybrid operator's add fused (K1).

Community-reordered adjacency is block-sparse: most edges land in a few
dense 128×128 tiles.  ``bsr_spmm_acc(b, x, init)`` computes
``init + Σ_k A_k · X[col_k]`` with tile ``k`` adding into block-row
``rows[k]``.

* On a CUDA tensor it launches the hand-written kernel
  ``csrc/bsr_spmm.cu`` (it replaces the TPU kernel
  ``fitgnn_tpu/ops/pallas/bsr_spmm.py:_kernel_acc``; the source note there
  says what bounds it on an H100 and what the design does about it).
* On a CPU tensor it runs the plain version ``bsr_spmm_acc_plain``: a
  batched matmul over the gathered X slabs, then ``index_add_`` over block
  rows, plus ``init``.

``bsr_spmm_acc.launches`` counts kernel launches.
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

    @property
    def nnz_blocks(self) -> int:
        return self.blocks.shape[0]

    def to(self, device) -> "BsrMatrix":
        return dataclass_to(self, device)


def build_bsr(senders: np.ndarray, receivers: np.ndarray, weight: np.ndarray,
              num_nodes_padded: int, with_transpose: bool = True
              ) -> BsrMatrix:
    """Host-side BCSR construction from a COO edge list (numpy), in the
    f32 grid-walk layout: the same blocks, rows, cols and row_splits as the
    JAX package's ``build_bsr`` with its defaults (block 128, group 1, no
    rowwalk, no einsum; those variants are ROADMAP.md §2 opt-ins).

    ``num_nodes_padded`` must be a multiple of 128.  Edges pointing at
    padding slots are harmless as long as their weight is 0."""
    block, dtype = BLOCK, np.float32
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
    # coverage fillers: the TPU grid leaves an unvisited out block
    # uninitialized, so every block-row gets ≥1 (zero) tile.  The CUDA
    # kernel writes every row itself; the fillers stay for parity and cost
    # one zero tile each.
    missing = np.setdiff1d(np.arange(nb, dtype=np.int32), rows)
    if missing.size:
        blocks = np.concatenate(
            [blocks, np.zeros((missing.size, block, block), dtype=dtype)])
        rows = np.concatenate([rows, missing])
        cols = np.concatenate([cols, np.zeros(missing.size, np.int32)])
        order = np.argsort(rows, kind="stable")
        blocks, rows, cols = blocks[order], rows[order], cols[order]

    t = None
    if with_transpose:
        t = build_bsr(receivers, senders, weight, num_nodes_padded,
                      with_transpose=False)
    row_splits = np.searchsorted(rows, np.arange(nb + 1)).astype(np.int32)
    return BsrMatrix(
        blocks=torch.from_numpy(blocks), rows=torch.from_numpy(rows),
        cols=torch.from_numpy(cols), num_row_blocks=nb, num_col_blocks=nb,
        transpose=t, row_splits=torch.from_numpy(row_splits))


def bsr_spmm_acc_plain(b: BsrMatrix, x: torch.Tensor,
                       init: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``init + A·x``: gather the (K, block, F) X slabs,
    one batched matmul, ``index_add_`` over block rows."""
    n, feat = x.shape
    xb = x.reshape(b.num_col_blocks, BLOCK, feat)
    prod = torch.bmm(b.blocks.to(x.dtype),
                     xb.index_select(0, b.cols.long()))
    out = init.clone().reshape(b.num_row_blocks, BLOCK, feat)
    return out.index_add_(0, b.rows.long(), prod).reshape(n, feat)


# blocks, row_splits, cols, x, init, out, num_row_blocks, feat, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]


def bsr_spmm_acc(b: BsrMatrix, x: torch.Tensor,
                 init: torch.Tensor) -> torch.Tensor:
    """``init + A·x`` for (N_pad, F) ``x`` and ``init``: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.  Forward only: the
    hybrid operator's autograd Function runs it on ``b.transpose`` for the
    backward."""
    if x.shape != init.shape or x.dim() != 2 \
            or x.shape[0] != b.num_row_blocks * BLOCK:
        raise ValueError(f"bsr_spmm_acc: x {tuple(x.shape)} and init "
                         f"{tuple(init.shape)} must both be "
                         f"({b.num_row_blocks * BLOCK}, F)")
    if x.device.type == "cpu":
        return bsr_spmm_acc_plain(b, x, init)
    if x.device.type != "cuda":
        raise ValueError(f"bsr_spmm_acc: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(init, "init", torch.float32, dev)
    kernels.require(b.blocks, "blocks", torch.float32, dev)
    kernels.require(b.row_splits, "row_splits", torch.int32, dev)
    kernels.require(b.cols, "cols", torch.int32, dev)
    if b.blocks.data_ptr() % 16:
        raise ValueError("bsr_spmm_acc: blocks must be 16-byte aligned")
    out = torch.empty_like(x)
    launch = kernels.function("bsr_spmm", "fitgnn_bsr_spmm_acc", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(
            kernels.ptr(b.blocks), kernels.ptr(b.row_splits),
            kernels.ptr(b.cols), kernels.ptr(x), kernels.ptr(init),
            kernels.ptr(out), b.num_row_blocks, x.shape[1],
            kernels.stream(dev))
    kernels.check(rc, "bsr_spmm_acc")
    bsr_spmm_acc.launches += 1
    return out


bsr_spmm_acc.launches = 0
