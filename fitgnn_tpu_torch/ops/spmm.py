"""SpMM: sparse adjacency × dense features.

``spmm_coo``: graphs under the hybrid operator's size gate aggregate here,
as the JAX package's ``spmm_coo`` does in XLA: graphs of at most
``DENSE_SPMM_MAX_N`` padded nodes through a dense (N, N) adjacency and one
matmul, larger ones through a per-edge gather and a segment sum, in plain
PyTorch.  A stack of S same-padded subgraphs (``x`` (S, N, F), edges
(S, E)) is aggregated at once, as the JAX package's ``jax.vmap`` of
``spmm_coo`` computes it: an (S, N, N) adjacency from one scatter and one
``torch.bmm``, or the segment sum over node ids offset by subgraph.

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


def flat_edges(senders: torch.Tensor, receivers: torch.Tensor,
               num_nodes: int) -> tuple:
    """A stack's (S, E) edge endpoints as ids into its (S·N) flattened
    node rows: subgraph ``i``'s node ``v`` becomes ``i·N + v``."""
    off = (torch.arange(senders.shape[0], device=senders.device)
           * num_nodes)[:, None]
    return ((senders.long() + off).reshape(-1),
            (receivers.long() + off).reshape(-1))


def dense_adjacency(values: torch.Tensor, senders: torch.Tensor,
                    receivers: torch.Tensor, num_nodes: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """``adj[..., r, s] = Σ values`` over the edges (duplicates add): (N, N)
    for one graph, (S, N, N) for a stack, from one ``scatter_add_`` into the
    flattened matrix (``index_put_`` with ``accumulate`` sorts its indices
    first on the GPU, a dozen launches more for a 24-node subgraph)."""
    lead = senders.shape[:-1]
    flat = (receivers.long() * num_nodes).add_(senders.long())
    if lead:
        flat = flat.add_(torch.arange(
            0, lead[0] * num_nodes * num_nodes, num_nodes * num_nodes,
            device=senders.device)[:, None])
    adj = torch.zeros(lead + (num_nodes, num_nodes), dtype=dtype,
                      device=senders.device)
    adj.view(-1).scatter_add_(0, flat.view(-1), values.to(dtype).reshape(-1))
    return adj


def spmm_coo(edge_weight: torch.Tensor, senders: torch.Tensor,
             receivers: torch.Tensor, x: torch.Tensor,
             num_nodes: int) -> torch.Tensor:
    """out[r] = Σ_{e: recv[e]=r} w[e] · x[send[e]]  — (N, F) result, or
    (S, N, F) for a stack.

    Padding edges must have weight 0 (they then contribute nothing even
    though they point at the padding node).
    """
    if use_dense(num_nodes):
        adj = dense_adjacency(edge_weight, senders, receivers, num_nodes,
                              x.dtype)
        return adj @ x if x.dim() == 2 else torch.bmm(adj, x)
    if x.dim() == 3:
        s, r = flat_edges(senders, receivers, num_nodes)
        out = spmm_coo(edge_weight.reshape(-1), s, r,
                       x.reshape(-1, x.shape[-1]), x.shape[0] * num_nodes)
        return out.reshape(x.shape[0], num_nodes, -1)
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
