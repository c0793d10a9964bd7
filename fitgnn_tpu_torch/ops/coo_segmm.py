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

K3w, ``segmm_weighted_spmm``, is the same sum with runtime per-edge
weights (GAT's straggler softmax numerators), differentiable in the
weights and ``x``, as the JAX package's ``segmm_weighted_spmm``: the
forward and ``dx`` launch the same kernel, which forms the edge weight
``w_edge[e]·weights[e]`` itself while it stages the edges (on the
transpose CSR ``w_edge[perm[e]]·weights[e]``, ``perm`` the forward
position of each transpose entry), so no elementwise pass runs before it;
``dw`` is the per-edge dot ``⟨g[r_e], x[s_e]⟩`` in plain PyTorch.

K6, ``segmm_weighted_spmm_den``, returns the softmax denominator beside
the numerator, ``den[r] = Σ_e w_edge[e]``, from one pass, as the JAX
package's ``segmm_weighted_spmm_den``: its forward is the same kernel with
a second output (``segmm_weighted_den_raw``); ``dx`` runs K3w's launch on
the transpose CSR and ``dw_e = ⟨g_num[r_e], x[s_e]⟩ + g_den[r_e]`` is plain
PyTorch.  The TPU's ``first_slot`` map (its saved gather is in padded slot
order) has no counterpart: this CSR is in edge order.

``segmm_spmm.launches``, ``segmm_weighted_raw.launches`` and
``segmm_weighted_den_raw.launches`` count kernel launches with static
weights, runtime weights, and runtime weights with the denominator;
``launch_shape(feat)`` reads the kernel's launch shape for ``feat``
columns.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

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


def _receivers(m: SegCsr) -> torch.Tensor:
    """The receiver of every edge, as ``row_ptr`` spells it out."""
    return torch.repeat_interleave(
        torch.arange(m.num_nodes, device=m.row_ptr.device),
        m.row_ptr.diff(), output_size=m.senders.shape[0])


def segmm_spmm_plain(m: SegCsr, x: torch.Tensor,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch straggler aggregation: gather, scale by ``weights``
    (``m.weights`` when None), ``index_add_`` onto the receivers."""
    w = m.weights if weights is None else weights
    y = x.index_select(0, m.senders.long()) * w[:, None].to(x.dtype)
    out = torch.zeros((m.num_nodes, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, _receivers(m), y)


def _edge_weights(m: SegCsr, w_edge: torch.Tensor,
                  perm: Optional[torch.Tensor]) -> torch.Tensor:
    """The plain versions' runtime edge weights, ``w_edge[perm]·weights``."""
    w = w_edge if perm is None else w_edge[perm.long()]
    return w.to(m.weights.dtype) * m.weights


# row_ptr, senders, weights, w_edge, perm, x, out, den, num_rows, feat,
# stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]


def _check_x(what: str, m: SegCsr, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[0] != m.num_nodes:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be "
                         f"({m.num_nodes}, F)")


def _launch(what: str, m: SegCsr, x: torch.Tensor,
            w_edge: Optional[torch.Tensor] = None,
            perm: Optional[torch.Tensor] = None,
            den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel over ``m``'s CSR: edge weights ``m.weights``, times
    ``w_edge`` (times ``w_edge[perm]``) when given; with ``den``
    ((num_nodes,) f32) it also writes the weight sums (K6)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    dev = x.device
    kernels.require(x, "x", torch.float32, dev)
    kernels.require(m.row_ptr, "row_ptr", torch.int32, dev)
    kernels.require(m.senders, "senders", torch.int32, dev)
    kernels.require(m.weights, "weights", torch.float32, dev)
    null = ctypes.c_void_p(None)
    ptrs = []
    for name, t, dtype in (("w_edge", w_edge, torch.float32),
                           ("perm", perm, torch.int32)):
        if t is None:
            ptrs.append(null)
            continue
        kernels.require(t, name, dtype, dev)
        if t.shape != m.senders.shape:
            raise ValueError(f"{what}: {name} {tuple(t.shape)} for "
                             f"{m.senders.shape[0]} edges")
        ptrs.append(kernels.ptr(t))
    if den is not None and x.shape[1] == 0:
        raise ValueError(f"{what}: F=0 leaves den unwritten")
    out = torch.empty_like(x)
    launch = kernels.function("coo_segmm", "fitgnn_segmm_spmm", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = launch(kernels.ptr(m.row_ptr), kernels.ptr(m.senders),
                    kernels.ptr(m.weights), *ptrs, kernels.ptr(x),
                    kernels.ptr(out), null if den is None else
                    kernels.ptr(den), m.num_nodes, x.shape[1],
                    kernels.stream(dev))
    kernels.check(rc, what)
    return out


def launch_shape(feat: int) -> dict:
    """The kernel's launch shape for ``feat`` columns: lanes a row, floats a
    lane, gathers in flight a lane and rows a CTA (builds the kernel)."""
    fn = kernels.function("coo_segmm", "fitgnn_segmm_shape",
                          [ctypes.c_int64, ctypes.c_void_p])
    cfg = (ctypes.c_int32 * 4)()
    kernels.check(fn(feat, cfg), "launch_shape")
    return dict(zip(("lanes", "floats_per_lane", "gathers_in_flight",
                     "rows_per_cta"), cfg))


def segmm_spmm(m: SegCsr, x: torch.Tensor) -> torch.Tensor:
    """out = A_straggler · x, (N_pad, F) → (N_pad, F): the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor.  Forward only: the
    hybrid operator's autograd Functions own the backward."""
    _check_x("segmm_spmm", m, x)
    if x.device.type == "cpu":
        return segmm_spmm_plain(m, x)
    out = _launch("segmm_spmm", m, x)
    segmm_spmm.launches += 1
    return out


segmm_spmm.launches = 0


def segmm_weighted_raw_plain(m: SegCsr, w_edge: torch.Tensor,
                             x: torch.Tensor,
                             perm: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Plain PyTorch K3w forward (``segmm_weighted_raw``'s CPU path)."""
    return segmm_spmm_plain(m, x, _edge_weights(m, w_edge, perm))


def segmm_weighted_raw(m: SegCsr, w_edge: torch.Tensor, x: torch.Tensor,
                       perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3w forward, ``out[r] = Σ_e w_edge[e]·m.weights[e]·x[s_e]`` with
    ``w_edge`` in ``m``'s edge order, or ``w_edge[perm[e]]`` for entry ``e``
    when ``perm`` is given (``dx`` on the transpose CSR): the CUDA kernel on
    a CUDA tensor, the plain version on a CPU tensor.  The static factor
    keeps padding edges (weight 0) inert whatever ``w_edge`` holds there."""
    _check_x("segmm_weighted_raw", m, x)
    if x.device.type == "cpu":
        return segmm_weighted_raw_plain(m, w_edge, x, perm)
    out = _launch("segmm_weighted_raw", m, x,
                  w_edge.to(m.weights.dtype).contiguous(), perm)
    segmm_weighted_raw.launches += 1
    return out


segmm_weighted_raw.launches = 0


class _SegmmWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, mt, senders, receivers, t_edge_perm, w_edge, x):
        ctx.mt = mt
        ctx.save_for_backward(senders, receivers, t_edge_perm, w_edge, x)
        return segmm_weighted_raw(m, w_edge, x)

    @staticmethod
    def backward(ctx, g):
        senders, receivers, t_edge_perm, w_edge, x = ctx.saved_tensors
        g = g.contiguous()
        dw = dx = None
        if ctx.needs_input_grad[6]:
            # the transpose list holds each edge at t_edge_perm's position
            dx = segmm_weighted_raw(ctx.mt, w_edge, g, t_edge_perm)
        if ctx.needs_input_grad[5]:
            dw = (g.index_select(0, receivers.long()).float()
                  * x.index_select(0, senders.long()).float()
                  ).sum(-1).to(w_edge.dtype)
        return None, None, None, None, None, dw, dx


def segmm_weighted_spmm(m: SegCsr, mt: SegCsr, senders: torch.Tensor,
                        receivers: torch.Tensor, t_edge_perm: torch.Tensor,
                        w_edge: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K3w: ``out[r] = Σ_e w_edge[e]·x[s_e]`` over the straggler edges, with
    runtime per-edge weights, differentiable in ``w_edge`` and ``x``.

    ``m``/``mt`` are the forward/transpose CSRs; ``senders``, ``receivers``
    and ``w_edge`` are in the forward (receiver-sorted) order that ``m``
    walks, so the forward needs no remap; ``t_edge_perm[i]`` is the
    forward position of transpose entry ``i``.  ``dx`` runs the kernel on
    ``mt``; ``dw[e] = ⟨g[r_e], x[s_e]⟩``."""
    return _SegmmWeighted.apply(m, mt, senders, receivers, t_edge_perm,
                                w_edge.contiguous(), x.contiguous())


def segmm_weighted_den_raw_plain(m: SegCsr, w_edge: torch.Tensor,
                                 x: torch.Tensor) -> tuple:
    """Plain PyTorch K6 forward (``segmm_weighted_den_raw``'s CPU path)."""
    w = _edge_weights(m, w_edge, None)
    den = torch.zeros(m.num_nodes, dtype=torch.float32, device=x.device)
    return (segmm_spmm_plain(m, x, w),
            den.index_add_(0, _receivers(m), w.float()))


def segmm_weighted_den_raw(m: SegCsr, w_edge: torch.Tensor,
                           x: torch.Tensor) -> tuple:
    """K6 forward, ``(num, den)`` with ``num[r] = Σ_e w_e·x[s_e]`` and
    ``den[r] = Σ_e w_e`` (f32), ``w_e = w_edge[e]·m.weights[e]`` in ``m``'s
    edge order: the CUDA kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    _check_x("segmm_weighted_den_raw", m, x)
    if x.device.type == "cpu":
        return segmm_weighted_den_raw_plain(m, w_edge, x)
    den = torch.empty(m.num_nodes, dtype=torch.float32, device=x.device)
    num = _launch("segmm_weighted_den_raw", m, x,
                  w_edge.to(m.weights.dtype).contiguous(), den=den)
    segmm_weighted_den_raw.launches += 1
    return num, den


segmm_weighted_den_raw.launches = 0


class _SegmmWeightedDen(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, mt, receivers, t_edge_perm, w_edge, x):
        ctx.m, ctx.mt = m, mt
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(receivers, t_edge_perm, w_edge, x)
        return segmm_weighted_den_raw(m, w_edge, x)

    @staticmethod
    def backward(ctx, g_num, g_den):
        receivers, t_edge_perm, w_edge, x = ctx.saved_tensors
        dw = dx = None
        if g_num is not None and ctx.needs_input_grad[5]:
            dx = segmm_weighted_raw(ctx.mt, w_edge, g_num.contiguous(),
                                    t_edge_perm)
        if ctx.needs_input_grad[4]:
            r = receivers.long()
            dw = torch.zeros(w_edge.shape, dtype=torch.float32,
                             device=w_edge.device)
            if g_num is not None:
                dw = dw + (g_num.index_select(0, r).float()
                           * x.index_select(0, ctx.m.senders.long()).float()
                           ).sum(-1)
            if g_den is not None:
                dw = dw + g_den.index_select(0, r).float()
            dw = dw.to(w_edge.dtype)
        return None, None, None, None, dw, dx


def segmm_weighted_spmm_den(m: SegCsr, mt: SegCsr, receivers: torch.Tensor,
                            t_edge_perm: torch.Tensor, w_edge: torch.Tensor,
                            x: torch.Tensor) -> tuple:
    """K6: ``(num, den)``, the GAT straggler numerator and softmax
    denominator in one pass, differentiable in ``w_edge`` and ``x``.

    ``m``/``mt`` are the forward/transpose CSRs; ``receivers`` and
    ``w_edge`` are in the forward (receiver-sorted) order that ``m`` walks;
    ``t_edge_perm[i]`` is the forward position of transpose entry ``i``.
    ``dx`` runs K3w's launch on ``mt``; ``dw_e = ⟨g_num[r_e], x[s_e]⟩ +
    g_den[r_e]``."""
    return _SegmmWeightedDen.apply(m, mt, receivers, t_edge_perm,
                                   w_edge.contiguous(), x.contiguous())
