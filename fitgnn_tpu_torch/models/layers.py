"""Message-passing layers on the port's SpMM ops.

* GCNConv: symmetric D^-1/2 (A+I) D^-1/2 aggregation of W·x (+bias).  The
  normalized weights are precomputed in ``graph.build``, so the layer is
  one dense matmul + one weighted SpMM.
* GATConv: single-head additive attention, softmax over incoming edges
  (self loops included), LeakyReLU(0.2), as the JAX package's ``GATConv``
  with ``heads=1``: the tile path on an ``att_unit`` hybrid operator
  (``ops/tile_gat.py``), a dense masked path for graphs of at most
  ``DENSE_SPMM_MAX_N`` padded nodes, and a per-edge path otherwise.

Both layers also take a stack of same-padded subgraphs (``x`` (S, N, F),
a ``Graph`` whose tensors have the subgraph axis in front), as the JAX
package's ``jax.vmap`` over a ``SubgraphBatch`` runs them.

SAGE and GIN are not ported yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from fitgnn_tpu_torch.graph.container import Graph
from fitgnn_tpu_torch.ops.hybrid_spmm import HybridSpmm, hybrid_spmm
from fitgnn_tpu_torch.ops.sddmm import gather_concat_score
from fitgnn_tpu_torch.ops.segment import segment_softmax, segment_sum, \
    take_rows
from fitgnn_tpu_torch.ops.spmm import (dense_adjacency, flat_edges,
                                       spmm_coo, use_dense)
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

_NEG = -1e30

# flax's lecun_normal: a normal truncated at ±2σ, rescaled so the variance
# stays 1/fan_in (the std of a unit normal truncated at ±2)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class GCNConv(nn.Module):
    """``lin`` stores the weight as ``nn.Linear`` does, (out, in)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.features = features
        self.lin = nn.Linear(in_features, features, bias=False)
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            lecun_normal_(self.lin.weight, self.lin.in_features, generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        if isinstance(g.aux, HybridSpmm) and g.aux.semantics == "gcn_norm":
            def agg(h):
                return hybrid_spmm(g.aux, h)
        else:
            def agg(h):
                return spmm_coo(g.edge_weight, g.senders, g.receivers, h,
                                g.num_nodes_padded)
        # Â(X·W) = (Â·X)·W — aggregate on the NARROW side of the layer: the
        # SpMM's traffic scales with the aggregated width, so an expanding
        # layer aggregates its input and a contracting one its output
        if self.features <= x.shape[-1]:
            out = agg(self.lin(x))
        else:
            out = self.lin(agg(x))
        return out + self.bias.to(out.dtype)


class GATConv(nn.Module):
    """Single-head GAT.  ``lin`` stores the JAX kernel transposed, as
    ``nn.Linear`` does, (out, in); ``att_src``/``att_dst`` are (1, out)."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2):
        super().__init__()
        self.features = features
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_features, features, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, features))
        self.att_dst = nn.Parameter(torch.empty(1, features))
        self.bias = nn.Parameter(torch.zeros(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: lecun_normal kernel, glorot_uniform attention
        vectors (bound sqrt(6 / (1 + out)) for a (1, out) shape), zero
        bias."""
        with torch.no_grad():
            lecun_normal_(self.lin.weight, self.lin.in_features, generator)
            nn.init.xavier_uniform_(self.att_src, generator=generator)
            nn.init.xavier_uniform_(self.att_dst, generator=generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        n, f_in, c = g.num_nodes_padded, x.shape[-1], self.features
        a_src, a_dst = self.att_src[0], self.att_dst[0]
        # aggregate on the NARROW side of an expanding layer (exact, since
        # the attention weight is a per-edge scalar): Σ α·(X·W)[s] =
        # (Σ α·X[s])·W, with scores x·(W·a) from the (F_in,) projected
        # attention vectors
        narrow = f_in < c
        if narrow:
            w = self.lin.weight                       # (C, F_in)
            v_src, v_dst = a_src @ w, a_dst @ w       # (F_in,)
            score_src, score_dst = x @ v_src, x @ v_dst
            h = x
        else:
            h = self.lin(x)
            score_src, score_dst = h @ a_src, h @ a_dst
        if isinstance(g.aux, HybridSpmm) and g.aux.semantics == "att_unit":
            out = tile_gat_attention(g.aux, score_src, score_dst, h,
                                     self.negative_slope,
                                     att_src=v_src if narrow else a_src)
        elif use_dense(n):
            out = self._dense(score_src, score_dst, h, g)
        elif x.dim() == 3:
            # a stack of large subgraphs: the per-edge path over the
            # flattened node rows
            s, r = flat_edges(g.senders, g.receivers, n)
            rows = x.shape[0] * n
            out = self._per_edge(score_src.reshape(-1),
                                 score_dst.reshape(-1),
                                 h.reshape(rows, -1), s, r,
                                 g.edge_mask.reshape(-1), rows)
            out = out.reshape(x.shape[0], n, -1)
        else:
            out = self._per_edge(score_src, score_dst, h, g.senders,
                                 g.receivers, g.edge_mask, n)
        if narrow:
            out = self.lin(out)                       # (Σ α·x)·W
        return out + self.bias

    def _per_edge(self, score_src, score_dst, h, senders, receivers,
                  edge_mask, n) -> torch.Tensor:
        e = F.leaky_relu(gather_concat_score(senders, receivers, score_src,
                                             score_dst), self.negative_slope)
        alpha = segment_softmax(e, receivers, n, mask=edge_mask)
        return segment_sum(take_rows(h, senders) * alpha[:, None],
                           receivers, n)

    def _dense(self, score_src, score_dst, h, g: Graph) -> torch.Tensor:
        """Dense masked attention for small graphs: an (N, N) edge-count
        mask from one scatter, then broadcast scores and one matmul; the
        same sums as the per-edge path (duplicate edges weight the exp by
        their count, empty rows hit the same 1e-16 clamp).  A stack takes
        (S, N, N) masks, the edge mask per subgraph."""
        n = g.num_nodes_padded
        cnt = dense_adjacency(g.edge_mask.float(), g.senders, g.receivers,
                              n, torch.float32)
        s = F.leaky_relu(score_dst[..., :, None] + score_src[..., None, :],
                         self.negative_slope)
        has = cnt > 0
        # the row max is a constant shift of a softmax: detached
        m = torch.where(has, s, _NEG).amax(dim=-1, keepdim=True).detach()
        m = torch.where(m <= -1e29, 0.0, m)
        # mask BEFORE the exp: a pair without an edge may score far above
        # its row's max, and exp overflowing there would turn the masked
        # zero gradient into 0·inf = NaN
        p = torch.exp(torch.where(has, s - m, _NEG)) * cnt
        alpha = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-16)
        return torch.matmul(alpha.to(h.dtype), h)


def make_layer(layer_name: str, in_features: int, hidden: int) -> nn.Module:
    if layer_name == "GCNConv":
        return GCNConv(in_features, hidden)
    if layer_name == "GATConv":
        return GATConv(in_features, hidden)
    raise NotImplementedError(
        f"layer {layer_name!r} is not ported yet (ROADMAP.md §1 item 2: "
        "SAGE and GIN)")
