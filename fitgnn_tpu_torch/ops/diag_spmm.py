"""Block-diagonal SpMM: the diagonal run (K8).

Community-reordered graphs put most of their dense-tile edges on the block
diagonal, where a tile's column block equals its row block, so block ``b``
multiplies X's own slab ``b``.  ``diag_spmm(blocks, x, r, transpose, init)``
computes ``out_b = (init_b +) A_b · x_b`` for (nb, E, E) ``blocks``, or
``A_bᵀ · x_b`` with ``transpose``, as the JAX package's ``diag_spmm_raw``
(its two call sites ``_diag_spmm`` and ``_diag_spmm_acc``).  The edge E is
the blocks' (128, or any multiple of 128: ``build_hybrid(block=E,
use_diag=True)``).  ``r`` is the TPU's run length (blocks per grid step);
it must divide ``nb`` there, and here too, though the CUDA grid does not
follow it.

* On a CUDA tensor ``diag_spmm`` launches the hand-written kernel of
  ``csrc/diag_spmm.cu``: the non-zero walk of ``csrc/tile_sparse.cuh`` over
  the diagonal blocks, which applies only each block's non-zeros (it
  replaces the TPU kernel ``fitgnn_tpu/ops/pallas/diag_spmm.py:_make_kernel``;
  the source note says what bounds it on an H100 and what the design does
  about it).  Above E = 128 the walk takes each block as 128-wide
  quadrants.
* On a CPU tensor it runs the plain version ``diag_spmm_plain``: one
  batched matmul over the (nb, E, F) views.

bf16 blocks (the JAX package's ``tile_dtype=bfloat16``): ``x`` is rounded
to bf16 in both orientations, as the TPU kernel casts it, and the exact
bf16 × bf16 products are summed in f32 (``init`` stays f32); the kernel is
the walk's bf16 form (``fitgnn_diag_spmm_bf16``).  f16 and fp8 blocks
leave ``x`` in f32 and are widened to f32 exactly, as the JAX package's
``jnp.dot`` promotes them: the plain version widens them on the CPU, and
they reach the card already widened (``HybridSpmm``), so the kernel sees
f32 blocks.

bf16 activations: K8 has no bf16-activation form; bf16 ``x`` and ``init``
take the widened route (``kernels.widened``: widened to f32, the form for
the blocks' type launched and counted as usual, the output rounded to
bf16 once), on either device.

``diag_spmm.launches`` counts kernel launches on f32 blocks,
``diag_spmm.launches_bf16`` on bf16 blocks.  No autograd: the hybrid
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
    if b <= 0 or b % 128:
        raise ValueError(f"diag_spmm: the block edge {b} is not a positive "
                         "multiple of 128")
    if init is not None and init.shape != x.shape:
        raise ValueError(f"diag_spmm: init {tuple(init.shape)} differs from "
                         f"x {tuple(x.shape)}")
    if r < 1 or nb % r:
        raise ValueError(f"diag_spmm: pad diag blocks to a multiple of r={r} "
                         f"(nb={nb})")


def diag_spmm_plain(blocks: torch.Tensor, x: torch.Tensor, r: int,
                    transpose: bool = False,
                    init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch K8: a batched matmul over the (nb, E, F) views (x
    rounded to bf16 first on bf16 blocks); bf16 ``x`` by the widened
    route."""
    if x.dtype == torch.bfloat16:
        return kernels.widened(lambda x, init: diag_spmm_plain(
            blocks, x, r, transpose, init), x, init)
    _check(blocks, x, r, init)
    nb, b, _ = blocks.shape
    a = blocks.to(x.dtype)
    if blocks.dtype == torch.bfloat16:
        x = x.to(torch.bfloat16).to(a.dtype)
    out = torch.bmm(a.transpose(1, 2) if transpose else a,
                    x.reshape(nb, b, -1)).reshape(x.shape)
    return out if init is None else out + init


# blocks, x, init, out, nb, feat, block, transpose, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + [ctypes.c_int,
                                                            ctypes.c_void_p]


def diag_spmm(blocks: torch.Tensor, x: torch.Tensor, r: int,
              transpose: bool = False,
              init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(init +) diag(A)·x`` (or ``diag(A)ᵀ·x``): the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor; bf16 ``x`` (and ``init``)
    through ``kernels.widened``."""
    if kernels.narrow("diag_spmm", x):
        return kernels.widened(
            lambda x, init: diag_spmm(blocks, x, r, transpose, init), x, init)
    if x.device.type == "cpu":
        return diag_spmm_plain(blocks, x, r, transpose, init)
    if x.device.type != "cuda":
        raise ValueError(f"diag_spmm: unsupported device {x.device}")
    _check(blocks, x, r, init)
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(blocks, "blocks",
                    torch.bfloat16 if blocks.dtype == torch.bfloat16
                    else torch.float32, dev)
    if init is not None:
        kernels.require(init, "init", torch.float32, dev)
    if blocks.data_ptr() % 16:
        raise ValueError("diag_spmm: blocks must be 16-byte aligned")
    out = torch.empty_like(x)
    launch = kernels.function(
        "diag_spmm", kernels.entry("fitgnn_diag_spmm", blocks), _ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(blocks), kernels.ptr(x),
                    None if init is None else kernels.ptr(init),
                    kernels.ptr(out), blocks.shape[0], x.shape[1],
                    blocks.shape[1], int(transpose), kernels.stream(dev))
    kernels.check(rc, "diag_spmm")
    kernels.count(diag_spmm, blocks)
    return out


diag_spmm.launches = diag_spmm.launches_bf16 = 0
