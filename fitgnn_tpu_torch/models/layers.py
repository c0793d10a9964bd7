"""Message-passing layers on the port's SpMM ops.

* GCNConv: symmetric D^-1/2 (A+I) D^-1/2 aggregation of W·x (+bias).  The
  normalized weights are precomputed in ``graph.build``, so the layer is
  one dense matmul + one weighted SpMM.
* GATConv: single-head additive attention, softmax over incoming edges
  (self loops included), LeakyReLU(0.2), as the JAX package's ``GATConv``
  with ``heads=1``: the tile path on an ``att_unit`` hybrid operator
  (``ops/tile_gat.py``), a dense masked path for graphs of at most
  ``DENSE_SPMM_MAX_N`` padded nodes, and a per-edge path otherwise.

* SAGEConv: ``lin_l(mean_neigh(x)) + lin_r(x)``, self loops left out of
  the mean: the hybrid operator when it carries ``mean_nonself`` weights
  (``1/indeg`` on non-self edges), else a ``w/deg``-weighted SpMM on the
  dense branch and a masked segment mean per edge.
* GINConv: ``relu(mlp_1(relu(mlp_0((1+ε)·x + Σ_neigh x))))`` with a
  trainable 0-dim ``eps``: the hybrid operator when it carries
  ``sum_nonself`` weights, else ``spmm_coo`` with the non-self weights.

Every layer also takes a stack of same-padded subgraphs (``x`` (S, N, F),
a ``Graph`` whose tensors have the subgraph axis in front), as the JAX
package's ``jax.vmap`` over a ``SubgraphBatch`` runs them.

The compute dtype (``dtype``; None, or ``torch.bfloat16`` as ``bench.py``
composes the JAX package's stack) follows flax's ``nn.Dense(dtype=…)``:
each dense transform casts its input and weight to the dtype and gives
its product in it (``dense``: the sums in f32, rounded once), the bias is
added in it, and the aggregations then run on that dtype's activations
(the kernels' bf16-activation forms, ``ops/``).  Parameters stay f32, so
state dicts and ``models/convert.py`` do not change.  GAT keeps its scores
and softmax in f32 and casts its messages to the dtype.

``forward(x, g)`` picks the aggregation from the graph and hands it to
``propagate(x, agg)``, which holds the layer's dense work and its choice
of the narrow side.  The hierarchical layer (``parallel/hierarchical.py``)
calls ``propagate`` with its own aggregation: ``agg(h)`` for GCN, SAGE and
GIN, ``agg(h, a_src, a_dst)`` (the attention vectors of ``h``'s width) for
GAT.
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
from fitgnn_tpu_torch.ops.segment import (segment_mean, segment_softmax,
                                          segment_sum, take_rows)
from fitgnn_tpu_torch.ops.spmm import (dense_adjacency, flat_edges,
                                       spmm_coo, use_dense)
from fitgnn_tpu_torch.ops.tile_gat import tile_gat_attention

_NEG = -1e30

# flax's lecun_normal: a normal truncated at ±2σ, rescaled so the variance
# stays 1/fan_in (the std of a unit normal truncated at ±2)
_TRUNC_STD = 0.87962566103423978


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of two 2-D matrices of a narrow type, the products summed
    in f32 and returned in f32: on the card cuBLAS's GEMM with an f32
    output (``out_dtype``), whose reduction is f32 whatever
    ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
    says (a bf16 output may take a reduced-precision split-K reduction
    under it); elsewhere the f32 product of the widened operands (exact
    products, f32 sums)."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _NarrowLinear(torch.autograd.Function):
    """``x·Wᵀ`` in the compute dtype ``dt``: x and W cast to it, the sums in
    f32, the product rounded to ``dt`` once, as the TPU's bf16 matmul
    (flax's ``nn.Dense(dtype=bf16)``).  The backward's two products are
    taken the same way; each gradient is rounded to ``dt`` and handed back
    in its input's type, as the backward of the casts gives it."""

    @staticmethod
    def forward(ctx, x, w, dt):
        xd, wd = x.to(dt), w.to(dt)
        ctx.save_for_backward(xd, wd)
        ctx.types = (x.dtype, w.dtype)
        x2 = xd.reshape(-1, xd.shape[-1])
        return _mm32(x2, wd.t()).to(dt).reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, g):
        xd, wd = ctx.saved_tensors
        x_t, w_t = ctx.types
        dt = xd.dtype
        g2 = g.to(dt).reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _mm32(g2, wd).to(dt).to(x_t).reshape(xd.shape)
        if ctx.needs_input_grad[1]:
            dw = _mm32(g2.t(), xd.reshape(-1, xd.shape[-1])).to(dt).to(w_t)
        return dx, dw, None


def dense(x: torch.Tensor, weight: torch.Tensor,
          dtype: Optional[torch.dtype] = None,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x·Wᵀ (+ b)`` with ``nn.Linear``'s (out, in) weight: in f32 without
    a ``dtype``, else in it (``_NarrowLinear``) with the bias cast to it
    and added in it, as flax's ``nn.Dense(dtype=…)``."""
    if dtype is None:
        return F.linear(x, weight, bias)
    out = _NarrowLinear.apply(x, weight, dtype)
    return out if bias is None else out + bias.to(dtype)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class GCNConv(nn.Module):
    """``lin`` stores the weight as ``nn.Linear`` does, (out, in);
    ``dtype`` the compute dtype (None: f32)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
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
        return self.propagate(x, agg)

    def propagate(self, x: torch.Tensor, agg) -> torch.Tensor:
        # Â(X·W) = (Â·X)·W — aggregate on the NARROW side of the layer: the
        # SpMM's traffic scales with the aggregated width, so an expanding
        # layer aggregates its input and a contracting one its output
        if self.features <= x.shape[-1]:
            out = agg(dense(x, self.lin.weight, self.dtype))
        else:
            out = dense(agg(x), self.lin.weight, self.dtype)
        return out + self.bias.to(out.dtype)


class GATConv(nn.Module):
    """Single-head GAT.  ``lin`` stores the JAX kernel transposed, as
    ``nn.Linear`` does, (out, in); ``att_src``/``att_dst`` are (1, out)."""

    def __init__(self, in_features: int, features: int,
                 negative_slope: float = 0.2,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.negative_slope = negative_slope
        self.dtype = dtype
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
        return self.propagate(
            x, lambda h, a_s, a_d: self._attend(h, a_s, a_d, g))

    def propagate(self, x: torch.Tensor, attend) -> torch.Tensor:
        """``attend(h, a_src, a_dst)``: the attention aggregation of the
        messages ``h`` under the (F,) attention vectors of their width.
        Under ``dtype`` the scores come from ``h`` in f32 (on the narrow
        side from the input as it is) and the messages are ``h`` cast to
        the dtype, as the JAX package's ``GATConv`` takes them."""
        f_in, c = x.shape[-1], self.features
        a_src, a_dst = self.att_src[0], self.att_dst[0]
        # aggregate on the NARROW side of an expanding layer (exact, since
        # the attention weight is a per-edge scalar): Σ α·(X·W)[s] =
        # (Σ α·X[s])·W, with scores x·(W·a) from the (F_in,) projected
        # attention vectors
        narrow = f_in < c
        if narrow:
            w = self.lin.weight                       # (C, F_in)
            out = dense(attend(x, a_src @ w, a_dst @ w), w,  # (Σ α·x)·W
                        self.dtype)
        else:
            out = attend(dense(x, self.lin.weight, self.dtype), a_src, a_dst)
        return out + self.bias.to(out.dtype)

    def _attend(self, h, a_src, a_dst, g: Graph) -> torch.Tensor:
        n = g.num_nodes_padded
        h32 = h.float()
        score_src, score_dst = h32 @ a_src, h32 @ a_dst
        if self.dtype is not None:
            h = h.to(self.dtype)                      # the messages
        if isinstance(g.aux, HybridSpmm) and g.aux.semantics == "att_unit":
            out = tile_gat_attention(g.aux, score_src, score_dst, h,
                                     self.negative_slope, att_src=a_src)
        elif use_dense(n):
            out = self._dense(score_src, score_dst, h, g)
        elif h.dim() == 3:
            # a stack of large subgraphs: the per-edge path over the
            # flattened node rows
            s, r = flat_edges(g.senders, g.receivers, n)
            rows = h.shape[0] * n
            out = self._per_edge(score_src.reshape(-1),
                                 score_dst.reshape(-1),
                                 h.reshape(rows, -1), s, r,
                                 g.edge_mask.reshape(-1), rows)
            out = out.reshape(h.shape[0], n, -1)
        else:
            out = self._per_edge(score_src, score_dst, h, g.senders,
                                 g.receivers, g.edge_mask, n)
        return out

    def _per_edge(self, score_src, score_dst, h, senders, receivers,
                  edge_mask, n) -> torch.Tensor:
        e = F.leaky_relu(gather_concat_score(senders, receivers, score_src,
                                             score_dst), self.negative_slope)
        alpha = segment_softmax(e, receivers, n, mask=edge_mask)
        return segment_sum(take_rows(h, senders) * alpha[:, None].to(h.dtype),
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


def _nonself_weight(g: Graph, dtype: torch.dtype) -> torch.Tensor:
    """1 on non-self-loop edges, else 0 (padding edges are self loops on
    the padding node, so they drop out too)."""
    return (g.senders != g.receivers).to(dtype)


def sage_aggregator(g: Graph, dtype: torch.dtype):
    """SAGE's neighbour mean as a function of the (N, F) or (S, N, F)
    features, as the JAX package's ``SAGEConv`` picks it."""
    if isinstance(g.aux, HybridSpmm) and g.aux.semantics == "mean_nonself":
        return lambda h: hybrid_spmm(g.aux, h)
    n = g.num_nodes_padded
    w = _nonself_weight(g, dtype)
    if use_dense(n):
        # a (w/deg)-weighted SpMM on the dense branch; a stack's in-degree
        # is taken per subgraph
        r = g.receivers.long()
        deg = torch.zeros(w.shape[:-1] + (n,), dtype=dtype,
                          device=w.device).scatter_add_(-1, r, w)
        wn = w * (1.0 / deg.clamp_min(1.0)).gather(-1, r)
        return lambda h: spmm_coo(wn, g.senders, g.receivers, h, n)
    if g.senders.dim() == 2:
        # a stack of large subgraphs: the mean over the flattened rows
        s, r = flat_edges(g.senders, g.receivers, n)
        mask = w.reshape(-1) > 0

        def agg(h):
            rows = h.shape[0] * n
            out = segment_mean(take_rows(h.reshape(rows, -1), s), r, rows,
                               mask=mask)
            return out.reshape(h.shape[0], n, -1)
        return agg
    return lambda h: segment_mean(take_rows(h, g.senders), g.receivers, n,
                                  mask=w > 0)


def gin_aggregator(g: Graph, dtype: torch.dtype):
    """GIN's neighbour sum, as the JAX package's ``GINConv`` picks it."""
    if isinstance(g.aux, HybridSpmm) and g.aux.semantics == "sum_nonself":
        return lambda h: hybrid_spmm(g.aux, h)
    w = _nonself_weight(g, dtype)
    return lambda h: spmm_coo(w, g.senders, g.receivers, h,
                              g.num_nodes_padded)


class SAGEConv(nn.Module):
    """``lin_l`` (with bias) on the neighbour mean plus ``lin_r`` (no bias)
    on the node itself, ``nn.Linear``'s (out, in) storage."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.lin_l = nn.Linear(in_features, features)
        self.lin_r = nn.Linear(in_features, features, bias=False)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: lecun_normal kernels, zero bias."""
        with torch.no_grad():
            lecun_normal_(self.lin_l.weight, self.lin_l.in_features,
                          generator)
            self.lin_l.bias.zero_()
            lecun_normal_(self.lin_r.weight, self.lin_r.in_features,
                          generator)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        return self.propagate(x, sage_aggregator(g, x.dtype))

    def propagate(self, x: torch.Tensor, agg) -> torch.Tensor:
        if self.features <= x.shape[-1]:
            # aggregate on the narrow side: mean(x)·W + b = mean(x·W) + b,
            # the bias added after the mean, so a node without neighbours
            # gets b as lin_l(mean(x)) gives it
            out = agg(dense(x, self.lin_l.weight, self.dtype))
            out = out + self.lin_l.bias.to(out.dtype)
        else:
            out = dense(agg(x), self.lin_l.weight, self.dtype,
                        self.lin_l.bias)
        return out + dense(x, self.lin_r.weight, self.dtype)


class GINConv(nn.Module):
    """``relu(mlp_1(relu(mlp_0((1+ε)·x + Σ_neigh x))))``; ``eps`` is a
    trainable 0-dim parameter, the MLP's hidden width ``features``."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.features = features
        self.dtype = dtype
        self.eps = nn.Parameter(torch.zeros(()))
        self.mlp_0 = nn.Linear(in_features, features)
        self.mlp_1 = nn.Linear(features, features)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's init: zero ``eps``, lecun_normal kernels, zero biases."""
        with torch.no_grad():
            self.eps.zero_()
            for lin in (self.mlp_0, self.mlp_1):
                lecun_normal_(lin.weight, lin.in_features, generator)
                lin.bias.zero_()

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        return self.propagate(x, gin_aggregator(g, x.dtype))

    def propagate(self, x: torch.Tensor, agg) -> torch.Tensor:
        dt = self.dtype
        if self.features <= x.shape[-1]:
            # aggregate on the narrow side: W₀((1+ε)x + Σx) + b₀
            # = (1+ε)(x·W₀) + Σ(x·W₀) + b₀
            h0 = dense(x, self.mlp_0.weight, dt)
            h = F.relu((1.0 + self.eps).to(h0.dtype) * h0 + agg(h0)
                       + self.mlp_0.bias.to(h0.dtype))
        else:
            h = (1.0 + self.eps).to(x.dtype) * x + agg(x)
            h = F.relu(dense(h, self.mlp_0.weight, dt, self.mlp_0.bias))
        return F.relu(dense(h, self.mlp_1.weight, dt, self.mlp_1.bias))


LAYERS = {"GCNConv": GCNConv, "GATConv": GATConv, "SAGEConv": SAGEConv,
          "GINConv": GINConv}


def make_layer(layer_name: str, in_features: int, hidden: int,
               dtype: Optional[torch.dtype] = None) -> nn.Module:
    if layer_name not in LAYERS:
        raise ValueError(f"unknown layer {layer_name!r}; choose from "
                         f"{sorted(LAYERS)}")
    return LAYERS[layer_name](in_features, hidden, dtype=dtype)
