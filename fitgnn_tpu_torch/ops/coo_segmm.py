"""Straggler segmented sum with the gather fused (K3).

The hybrid operator's straggler edges (those outside the dense tiles) are
scattered, about one edge per tile.  ``segmm_spmm(m, x)`` computes
``out[r] = Σ_{e: recv[e]=r} w[e] · x[send[e]]`` over them, what the JAX
package's ``segmm_spmm`` computes with its selector-matmul kernel.

The port's structure is a receiver CSR (``row_ptr`` over the
receiver-sorted straggler list, ``senders`` and ``weights`` beside it)
rather than the TPU's chunked ``SegMM``: a GPU gathers rows directly and
needs neither the selector nor the chunk padding.

* On a CUDA tensor ``segmm_spmm`` launches the hand-written kernel
  ``csrc/coo_segmm.cu`` (it replaces the TPU kernel
  ``fitgnn_tpu/ops/pallas/coo_segmm.py:_kernel``; the source note there
  says what bounds it on an H100 and what the design does about it).
* On a CPU tensor it runs the plain version ``segmm_spmm_plain``:
  ``index_select``, multiply, ``index_add_``.

``segmm_spmm.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fitgnn_tpu_torch.ops import kernels
from fitgnn_tpu_torch.utils.device import dataclass_to


@dataclasses.dataclass
class SegCsr:
    """Receiver-CSR straggler list (receiver-sorted)."""

    row_ptr: torch.Tensor       # (num_nodes+1,) int32 edge range per row
    senders: torch.Tensor       # (E,) int32
    weights: torch.Tensor       # (E,) f32
    num_nodes: int

    def to(self, device) -> "SegCsr":
        return dataclass_to(self, device)


def build_segmm(senders: np.ndarray, receivers: np.ndarray,
                weight: np.ndarray, num_nodes_padded: int) -> SegCsr:
    """Host-side build from a RECEIVER-SORTED COO edge list."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    if (np.diff(receivers) < 0).any():
        raise ValueError("build_segmm: receivers must be sorted")
    if len(senders) >= 2**31:
        raise ValueError("build_segmm: more than 2**31-1 edges")
    row_ptr = np.searchsorted(receivers, np.arange(num_nodes_padded + 1))
    return SegCsr(
        row_ptr=torch.from_numpy(row_ptr.astype(np.int32)),
        senders=torch.from_numpy(senders.astype(np.int32)),
        weights=torch.from_numpy(np.asarray(weight, dtype=np.float32)),
        num_nodes=num_nodes_padded)


def segmm_spmm_plain(m: SegCsr, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch straggler aggregation: gather, scale, ``index_add_``
    onto the receivers that ``row_ptr`` spells out."""
    receivers = torch.repeat_interleave(
        torch.arange(m.num_nodes, device=m.row_ptr.device),
        m.row_ptr.diff(), output_size=m.senders.shape[0])
    y = x.index_select(0, m.senders.long()) * m.weights[:, None].to(x.dtype)
    out = torch.zeros((m.num_nodes, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, receivers, y)


# row_ptr, senders, weights, x, out, num_rows, feat, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]


def segmm_spmm(m: SegCsr, x: torch.Tensor) -> torch.Tensor:
    """out = A_straggler · x, (N_pad, F) → (N_pad, F): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.  Forward only."""
    if x.dim() != 2 or x.shape[0] != m.num_nodes:
        raise ValueError(f"segmm_spmm: x {tuple(x.shape)} must be "
                         f"({m.num_nodes}, F)")
    if x.device.type == "cpu":
        return segmm_spmm_plain(m, x)
    if x.device.type != "cuda":
        raise ValueError(f"segmm_spmm: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise NotImplementedError(
            "segmm_spmm: the kernel's backward (transpose list) comes with "
            "the training slice (ROADMAP.md §1)")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(m.row_ptr, "row_ptr", torch.int32, dev)
    kernels.require(m.senders, "senders", torch.int32, dev)
    kernels.require(m.weights, "weights", torch.float32, dev)
    out = torch.empty_like(x)
    launch = kernels.function("coo_segmm", "fitgnn_segmm_spmm", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(
            kernels.ptr(m.row_ptr), kernels.ptr(m.senders),
            kernels.ptr(m.weights), kernels.ptr(x), kernels.ptr(out),
            m.num_nodes, x.shape[1], kernels.stream(dev))
    kernels.check(rc, "segmm_spmm")
    segmm_spmm.launches += 1
    return out


segmm_spmm.launches = 0
