"""Block-diagonal SpMM: the diagonal run (K8).

Community-reordered graphs put most of their dense-tile edges on the block
diagonal, where a tile's column block equals its row block, so block ``b``
multiplies X's own slab ``b``.  ``diag_spmm(blocks, x, r, transpose, init)``
computes ``out_b = (init_b +) A_b · x_b`` for (nb, 128, 128) ``blocks``, or
``A_bᵀ · x_b`` with ``transpose``, as the JAX package's ``diag_spmm_raw``
(its two call sites ``_diag_spmm`` and ``_diag_spmm_acc``).  ``r`` is the
TPU's run length (blocks per grid step); it must divide ``nb`` there, and
here too, though the CUDA grid does not follow it.

* On a CUDA tensor ``diag_spmm`` launches the hand-written kernel of
  ``csrc/diag_spmm.cu``: the non-zero walk of ``csrc/tile_sparse.cuh`` over
  the diagonal blocks, which applies only each block's non-zeros (it
  replaces the TPU kernel ``fitgnn_tpu/ops/pallas/diag_spmm.py:_make_kernel``;
  the source note says what bounds it on an H100 and what the design does
  about it).
* On a CPU tensor it runs the plain version ``diag_spmm_plain``: one
  batched matmul over the (nb, 128, F) views.

``diag_spmm.launches`` counts kernel launches.  No autograd: the hybrid
operator differentiates through its transpose chain.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fitgnn_tpu_torch.ops import kernels


def pick_run_length(nb: int, max_r: int = 8) -> int:
    """Largest r ≤ max_r dividing nb (diag blocks per TPU grid step)."""
    for r in range(min(max_r, nb), 0, -1):
        if nb % r == 0:
            return r
    return 1


def _check(blocks: torch.Tensor, x: torch.Tensor, r: int,
           init: Optional[torch.Tensor]) -> None:
    nb, b, b2 = blocks.shape
    if b != b2 or x.dim() != 2 or x.shape[0] != nb * b:
        raise ValueError(f"diag_spmm: blocks {tuple(blocks.shape)} and x "
                         f"{tuple(x.shape)} do not match")
    if init is not None and init.shape != x.shape:
        raise ValueError(f"diag_spmm: init {tuple(init.shape)} differs from "
                         f"x {tuple(x.shape)}")
    if r < 1 or nb % r:
        raise ValueError(f"diag_spmm: pad diag blocks to a multiple of r={r} "
                         f"(nb={nb})")


def diag_spmm_plain(blocks: torch.Tensor, x: torch.Tensor, r: int,
                    transpose: bool = False,
                    init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K8: a batched matmul over the (nb, 128, F) views."""
    _check(blocks, x, r, init)
    nb, b, _ = blocks.shape
    a = blocks.to(x.dtype)
    out = torch.bmm(a.transpose(1, 2) if transpose else a,
                    x.reshape(nb, b, -1)).reshape(x.shape)
    return out if init is None else out + init


# blocks, x, init, out, nb, feat, transpose, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 2 + [ctypes.c_int,
                                                            ctypes.c_void_p]


def diag_spmm(blocks: torch.Tensor, x: torch.Tensor, r: int,
              transpose: bool = False,
              init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(init +) diag(A)·x`` (or ``diag(A)ᵀ·x``): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return diag_spmm_plain(blocks, x, r, transpose, init)
    if x.device.type != "cuda":
        raise ValueError(f"diag_spmm: unsupported device {x.device}")
    _check(blocks, x, r, init)
    if blocks.shape[1] != 128:
        raise ValueError("diag_spmm: the kernel takes 128-wide blocks, got "
                         f"{blocks.shape[1]}")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(blocks, "blocks", torch.float32, dev)
    if init is not None:
        kernels.require(init, "init", torch.float32, dev)
    if blocks.data_ptr() % 16:
        raise ValueError("diag_spmm: blocks must be 16-byte aligned")
    out = torch.empty_like(x)
    launch = kernels.function("diag_spmm", "fitgnn_diag_spmm", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(x),
                    None if init is None else kernels.ptr(init),
                    kernels.ptr(out), blocks.shape[0], x.shape[1],
                    int(transpose), kernels.stream(dev))
    kernels.check(rc, "diag_spmm")
    diag_spmm.launches += 1
    return out


diag_spmm.launches = 0
