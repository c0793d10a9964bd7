"""ELL (padded-neighbourhood) SpMM: aggregation without a scatter.

Each node's in-neighbours are padded to a fixed width K, so

    out[i] = Σ_k w[i,k] · x[nbr[i,k]]            (N, K, F) → (N, F)

is a gather followed by a dense reduction.  Degree buckets bound the
padding: nodes are grouped by their degree rounded up to a power of two,
and each bucket gets its own (nb, K_b) table; the buckets write disjoint
output rows.  Padding slots point at the padded graph's sink node (its
last) with weight 0.

The JAX package's ``fitgnn_tpu/ops/ell_spmm.py`` is XLA (no Pallas
kernel), so this is plain PyTorch on every device: ``build_ell`` gives the
same tables, ``ell_spmm`` the same sums, and its backward runs ``Aᵀ·g``
through the transpose tables, as the JAX package's ``_ell_bwd`` does.
``ops/spmm.py``'s ``spmm(operator=EllMatrix)`` dispatches here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from fitgnn_tpu_torch.utils.device import dataclass_to


@dataclasses.dataclass
class EllBucket:
    rows: torch.Tensor       # (nb,) int32 output node ids
    cols: torch.Tensor       # (nb, K) int32 source node ids (padding → sink)
    weights: torch.Tensor    # (nb, K) float32, 0 on padding

    def to(self, device) -> "EllBucket":
        return dataclass_to(self, device)


@dataclasses.dataclass
class EllMatrix:
    buckets: Tuple[EllBucket, ...]
    num_nodes: int
    transpose: Optional["EllMatrix"] = None   # Aᵀ for the backward pass

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(
            self, buckets=tuple(b.to(device) for b in self.buckets),
            transpose=None if self.transpose is None
            else self.transpose.to(device))


def _bucket(rows, cols, weights) -> EllBucket:
    return EllBucket(rows=torch.from_numpy(rows.astype(np.int32)),
                     cols=torch.from_numpy(cols.astype(np.int32)),
                     weights=torch.from_numpy(weights.astype(np.float32)))


def build_ell(senders: np.ndarray, receivers: np.ndarray, weight: np.ndarray,
              num_nodes_padded: int, min_k: int = 4, max_k: int = 4096,
              with_transpose: bool = True) -> EllMatrix:
    """Degree-bucketed ELL tables (host-side), as the JAX package's
    ``build_ell``: receivers need not be sorted; bucket widths run
    ``min_k``, 2·``min_k``, … up to ``max_k``, a soft cap: where a node's
    degree exceeds it, the last bucket widens to the largest degree, so
    that no edge is dropped."""
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    weight = np.asarray(weight, dtype=np.float32)
    n = num_nodes_padded
    sink = n - 1

    order = np.argsort(receivers, kind="stable")
    s, w = senders[order], weight[order]
    deg = np.bincount(receivers[order], minlength=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    starts[1:] = np.cumsum(deg)

    t = None
    if with_transpose:
        t = build_ell(receivers, senders, weight, num_nodes_padded,
                      min_k=min_k, max_k=max_k, with_transpose=False)

    deg_nodes = np.where(deg > 0)[0]
    if len(deg_nodes) == 0:
        return EllMatrix(buckets=(_bucket(
            np.array([sink]), np.full((1, min_k), sink),
            np.zeros((1, min_k))),), num_nodes=n, transpose=t)

    buckets: List[EllBucket] = []
    kmax = int(deg[deg_nodes].max())
    k = min_k
    while True:
        lo = 1 if k == min_k else k // 2 + 1
        hi = k
        if k >= max_k and kmax > k:
            # the soft cap: hubs above max_k keep every edge
            hi = k = kmax
        sel = deg_nodes[(deg[deg_nodes] >= lo) & (deg[deg_nodes] <= hi)]
        if len(sel):
            nb = len(sel)
            cols = np.full((nb, k), sink, dtype=np.int64)
            ws = np.zeros((nb, k), dtype=np.float32)
            # each node's edge run scattered into its row of the table
            lens = deg[sel]
            offs = np.repeat(np.cumsum(lens) - lens, lens)
            pos = np.arange(int(lens.sum())) - offs
            row_idx = np.repeat(np.arange(nb), lens)
            flat = pos + np.repeat(starts[sel], lens)
            cols[row_idx, pos] = s[flat]
            ws[row_idx, pos] = w[flat]
            buckets.append(_bucket(sel, cols, ws))
        if k >= kmax or k >= max_k:
            break
        k *= 2
    return EllMatrix(buckets=tuple(buckets), num_nodes=n, transpose=t)


def _ell_apply(m: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Each bucket's gather and weighted sum into its (disjoint) rows."""
    out = torch.zeros((m.num_nodes, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    for b in m.buckets:
        gathered = x[b.cols.long()]                       # (nb, K, F)
        agg = torch.einsum("bk,bkf->bf", b.weights.to(x.dtype), gathered)
        out.index_copy_(0, b.rows.long(), agg)
    return out


class _EllSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, x):
        ctx.m = m
        return _ell_apply(m, x)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None
        if ctx.m.transpose is None:
            raise ValueError("build_ell(with_transpose=True) required for "
                             "grad")
        return None, _ell_apply(ctx.m.transpose, g.contiguous())


def ell_spmm(m: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """``A·x`` through the bucketed gathers, (N_pad, F) → (N_pad, F),
    differentiable in ``x`` (the backward gathers through
    ``m.transpose``)."""
    return _EllSpmm.apply(m, x)
