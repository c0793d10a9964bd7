"""COO SpMM: sparse adjacency × dense features, plain PyTorch.

Graphs under the hybrid operator's size gate aggregate here, as the JAX
package's ``spmm_coo`` does in XLA: graphs of at most ``DENSE_SPMM_MAX_N``
padded nodes through a dense (N, N) adjacency and one matmul, larger ones
through a per-edge gather and a segment sum.
"""

from __future__ import annotations

import torch

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
