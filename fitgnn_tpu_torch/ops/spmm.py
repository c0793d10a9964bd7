"""SpMM: sparse adjacency × dense features.

``spmm_coo``: graphs under the hybrid operator's size gate aggregate here,
as the JAX package's ``spmm_coo`` does in XLA: graphs of at most
``DENSE_SPMM_MAX_N`` padded nodes through a dense (N, N) adjacency and one
matmul, larger ones through a per-edge gather and a segment sum, in plain
PyTorch.

``spmm(..., operator=...)`` dispatches on a precomputed operator structure
as the JAX package's ``spmm`` does: ``HybridSpmm`` (``ops/hybrid_spmm.py``),
``BsrMatrix`` (``bsr_spmm``: K2, K9 or K10 by its layout) or ``SegCsr``
(K3, forward only); plain COO without one.
"""

from __future__ import annotations

import torch

from fitgnn_tpu_torch.ops.bsr_spmm import BsrMatrix, bsr_spmm
from fitgnn_tpu_torch.ops.coo_segmm import SegCsr, segmm_spmm
from fitgnn_tpu_torch.ops.segment import segment_sum, take_rows

# the JAX package's default (its FITGNN_DENSE_SPMM_N); the port reads no
# environment variable
DENSE_SPMM_MAX_N = 512


def use_dense(num_nodes: int) -> bool:
    """True when ``spmm_coo`` (and GATConv) take the dense branch."""
    return num_nodes <= DENSE_SPMM_MAX_N


def spmm_coo(edge_weight: torch.Tensor, senders: torch.Tensor,
             receivers: torch.Tensor, x: torch.Tensor,
             num_nodes: int) -> torch.Tensor:
    """out[r] = Σ_{e: recv[e]=r} w[e] · x[send[e]]  — (N, F) result.

    Padding edges must have weight 0 (they then contribute nothing even
    though they point at the padding node).
    """
    if use_dense(num_nodes) and x.dim() == 2:
        adj = torch.zeros((num_nodes, num_nodes), dtype=x.dtype,
                          device=x.device)
        adj.index_put_((receivers.long(), senders.long()),
                       edge_weight.to(x.dtype), accumulate=True)
        return adj @ x
    gathered = take_rows(x, senders) * edge_weight[:, None].to(x.dtype)
    return segment_sum(gathered, receivers, num_nodes)


def spmm(edge_weight: torch.Tensor, senders: torch.Tensor,
         receivers: torch.Tensor, x: torch.Tensor, num_nodes: int, *,
         operator=None) -> torch.Tensor:
    """``A·x`` through ``operator`` when one is given, else ``spmm_coo``."""
    if operator is None:
        return spmm_coo(edge_weight, senders, receivers, x, num_nodes)
    if isinstance(operator, BsrMatrix):
        return bsr_spmm(operator, x)
    if isinstance(operator, SegCsr):
        return segmm_spmm(operator, x)
    name = type(operator).__name__
    if name == "HybridSpmm":
        # ops/hybrid_spmm.py imports this module
        from fitgnn_tpu_torch.ops.hybrid_spmm import hybrid_spmm
        return hybrid_spmm(operator, x)
    if name == "EllMatrix":
        raise NotImplementedError("spmm: the ELL operator (ops/ell_spmm.py) "
                                  "is not ported yet (ROADMAP.md §1 item 2)")
    raise TypeError(f"unknown SpMM operator {name}")
