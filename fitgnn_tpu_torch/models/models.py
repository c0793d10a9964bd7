"""Task models: conv stack + dense head.

``NodeModel`` is the JAX package's ``NodeModel`` (convs → dense head;
log_softmax for classification, the raw scalar for regression).
``GraphModel`` is its ``GraphModel``: convs → a masked pool over each
sample's rows (max for classification, mean for regression) → dense head;
softmax for classification.  Its Gc view (``forward``) runs on a
block-diagonal batch of coarse graphs, its Gs view
(``forward_subgraphs``) on every subgraph of a ``SubgraphBatch`` at once;
both take the same parameters.  Dropout
runs only in train mode (``model.train()``) and draws from a
``torch.Generator`` the caller passes to ``forward``, never from torch's
global generator; eval mode (the serve path) has no dropout.  The dropout
of a layer follows the JAX package's precedence: the byte-mask dropout at
rate ½ under ``bit_dropout`` (the default), else the in-kernel Philox
dropout (K11, ``ops/dropout.py``) under ``fused_dropout``, else Bernoulli
dropout from a uniform draw.

The conv stack's compute dtype (``NodeModel(dtype=torch.bfloat16)``, the
JAX package's ``NodeModel(dtype=jnp.bfloat16)``, which ``bench.py``
composes): every conv layer, the pre-aggregated layers and the head
compute in it (``models/layers.py``), the dropouts work in the
activations' type, and only the logits are promoted to f32 for the
``log_softmax`` (a regression output is returned in f32).  Parameters stay
f32.  ``GraphModel`` takes no dtype, as in the JAX package.

Layer-0 pre-aggregation (``first_layer_preaggregated``), as the JAX
package's: the input features are constant, so layer 0's aggregation runs
once at ingest (``preaggregate_input``) and the layer becomes dense work
alone (``_PreAggGCN``, ``_PreAggSAGE``, ``_PreAggGIN``).  Their parameters
carry the regular layer's names and shapes, so one state dict loads into
either model.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch
from fitgnn_tpu_torch.models.layers import (GCNConv, GINConv, SAGEConv,
                                            dense, gin_aggregator,
                                            lecun_normal_, make_layer,
                                            sage_aggregator)
from fitgnn_tpu_torch.ops.dropout import fused_dropout, seed_from_generator
from fitgnn_tpu_torch.ops.hybrid_spmm import HybridSpmm, hybrid_spmm
from fitgnn_tpu_torch.ops.segment import segment_max, segment_mean
from fitgnn_tpu_torch.ops.spmm import spmm_coo


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator,
            bit: bool = True) -> torch.Tensor:
    """Inverted dropout with the mask drawn from ``generator``.

    ``rate == 0.5`` with ``bit`` follows the JAX package's
    ``_bit_dropout_half``: one random byte per element, kept where its low
    bit is 1 (exact Bernoulli(½)), scale 2.  Otherwise an element is kept
    where a uniform draw is ≥ ``rate`` and scaled by ``1 / (1 − rate)``, as
    flax's ``nn.Dropout``."""
    if rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    if bit and rate == 0.5:
        bits = torch.randint(0, 256, x.shape, dtype=torch.uint8,
                             device=x.device, generator=generator)
        return torch.where((bits & 1).bool(), x * 2.0, 0.0)
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class _PreAggGCN(GCNConv):
    """Layer 0 of a pre-aggregated GCN stack: the input is already Â·X, so
    only the dense transform and the bias remain."""

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        h = dense(x, self.lin.weight, self.dtype)
        return h + self.bias.to(h.dtype)


class _PreAggSAGE(SAGEConv):
    """Layer 0 of a pre-aggregated SAGE stack: the input is
    ``concat([X, mean_neigh(X)])``; out = lin_l(mean) + lin_r(X)."""

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        x_raw, x_mean = x.chunk(2, dim=-1)
        return (dense(x_mean, self.lin_l.weight, self.dtype, self.lin_l.bias)
                + dense(x_raw, self.lin_r.weight, self.dtype))


class _PreAggGIN(GINConv):
    """Layer 0 of a pre-aggregated GIN stack: the input is
    ``concat([X, sum_neigh(X)])``; ε multiplies only the raw half."""

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        x_raw, x_sum = x.chunk(2, dim=-1)
        h = (1.0 + self.eps).to(x_raw.dtype) * x_raw + x_sum
        h = F.relu(dense(h, self.mlp_0.weight, self.dtype, self.mlp_0.bias))
        return F.relu(dense(h, self.mlp_1.weight, self.dtype,
                            self.mlp_1.bias))


_PREAGG = {"GCNConv": _PreAggGCN, "SAGEConv": _PreAggSAGE,
           "GINConv": _PreAggGIN}


class ConvStack(nn.Module):
    """``num_layers`` convs, each followed by ELU and, in train mode,
    dropout(``dropout_rate``): bit dropout when ``bit_dropout`` and the rate
    is ½, else K11 when ``fused_dropout`` (one seed a layer, drawn from the
    generator), else Bernoulli dropout.  ``first_layer_preaggregated``:
    layer 0 takes ``preaggregate_input``'s features (GCN, SAGE, GIN).
    ``dtype``: every layer's compute dtype (None: f32)."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, dropout_rate: float = 0.5,
                 fused_dropout: bool = False, bit_dropout: bool = True,
                 first_layer_preaggregated: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if first_layer_preaggregated and layer_name not in _PREAGG:
            raise ValueError("pre-aggregation is exact for GCN/SAGE/GIN only")
        self.layers = nn.ModuleList(
            _PREAGG[layer_name](in_dim, hidden, dtype=dtype)
            if i == 0 and first_layer_preaggregated
            else make_layer(layer_name, in_dim if i == 0 else hidden, hidden,
                            dtype)
            for i in range(num_layers))
        self.dropout_rate = dropout_rate
        self.fused_dropout = fused_dropout
        self.bit_dropout = bit_dropout

    def _dropout(self, x: torch.Tensor,
                 generator: torch.Generator) -> torch.Tensor:
        rate = self.dropout_rate
        if self.bit_dropout and rate == 0.5:
            return dropout(x, rate, generator)
        if self.fused_dropout:
            return fused_dropout(x, seed_from_generator(generator, x.device),
                                 rate)
        return dropout(x, rate, generator, bit=False)

    def forward(self, x: torch.Tensor, g: Optional[Graph],
                generator: Optional[torch.Generator] = None,
                agg_for=None) -> torch.Tensor:
        """``agg_for(layer)``, when given, is the aggregation each layer's
        ``propagate`` runs instead of the one ``g`` picks (the hierarchical
        exchange's); ``g`` is then unused."""
        drop = self.training and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("ConvStack: train-mode dropout needs an explicit "
                             "torch.Generator")
        for layer in self.layers:
            x = F.elu(layer(x, g) if agg_for is None
                      else layer.propagate(x, agg_for(layer)))
            if drop:
                x = self._dropout(x, generator)
        return x


class NodeModel(nn.Module):
    """Convs → dense head.  ``dtype`` (None or ``torch.bfloat16``): the
    compute dtype of the stack and the head; the logits are promoted to
    f32 for the ``log_softmax``."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True,
                 dropout_rate: float = 0.5, fused_dropout: bool = False,
                 bit_dropout: bool = True,
                 first_layer_preaggregated: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.classify = classify
        self.dtype = dtype
        self.convs = ConvStack(layer_name, in_dim, hidden, num_layers,
                               dropout_rate, fused_dropout, bit_dropout,
                               first_layer_preaggregated, dtype)
        self.head = nn.Linear(hidden, out_dim)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's default init (lecun_normal kernels, zero biases), drawn
        from ``generator`` in a fixed order: the layers, then the head."""
        for layer in self.convs.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            lecun_normal_(self.head.weight, self.head.in_features, generator)
            self.head.bias.zero_()
        return self

    def forward(self, x: torch.Tensor, g: Optional[Graph],
                generator: Optional[torch.Generator] = None,
                agg_for=None) -> torch.Tensor:
        """Log-probs (classification) or the raw scalar; ``generator``
        drives the dropout masks in train mode, ``agg_for`` as
        ``ConvStack.forward``'s."""
        out = dense(self.convs(x, g, generator, agg_for), self.head.weight,
                    self.dtype, self.head.bias)
        if self.classify:
            return F.log_softmax(out.float(), dim=-1)
        return out.float()


class GraphModel(nn.Module):
    """Graph-level model.  Dropout as ``ConvStack``'s (bit dropout at the
    default rate ½, as the JAX ``GraphModel``'s stack)."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True,
                 dropout_rate: float = 0.5):
        super().__init__()
        self.classify = classify
        self.convs = ConvStack(layer_name, in_dim, hidden, num_layers,
                               dropout_rate)
        self.head = nn.Linear(hidden, out_dim)

    reset_parameters = NodeModel.reset_parameters

    def _pool_and_head(self, h: torch.Tensor, segment_ids: torch.Tensor,
                       num_graphs: int, mask: torch.Tensor) -> torch.Tensor:
        pool = segment_max if self.classify else segment_mean
        out = self.head(pool(h, segment_ids, num_graphs, mask=mask))
        if self.classify:
            return F.softmax(out.float(), dim=-1)
        return out.float()

    def forward(self, x: torch.Tensor, g: Graph, graph_ids: torch.Tensor,
                num_graphs: int,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Gc view: ``g`` is a block-diagonal batch of coarse graphs and
        ``graph_ids`` (N_pad,) assigns each node to its sample (PyG's
        ``batch``); padding nodes are left out of the pool.  (num_graphs,
        out_dim) probabilities or raw outputs."""
        h = self.convs(x, g, generator)
        return self._pool_and_head(h, graph_ids, num_graphs, g.node_mask)

    def forward_subgraphs(self, batch: SubgraphBatch,
                          graph_ids: torch.Tensor, num_graphs: int,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """Gs view: the stack on every subgraph at once, then one pool
        over each sample's consuming rows across its subgraphs;
        ``graph_ids`` (S, N_pad) gives each node slot's sample."""
        h = self.convs(batch.x, batch.graphs(), generator)
        return self._pool_and_head(h.reshape(-1, h.shape[-1]),
                                   graph_ids.reshape(-1), num_graphs,
                                   batch.consume_mask.reshape(-1))


def preaggregate_features(g: Graph) -> torch.Tensor:
    """x̃ = Â·X, computed once at ingest for a pre-aggregated GCN (through
    the graph's hybrid operator when it has one: K3 then K1, in its form
    for the tiles' type; x rounded to bf16 on bf16 tiles alone)."""
    if isinstance(g.aux, HybridSpmm):
        return hybrid_spmm(g.aux, g.x)
    return spmm_coo(g.edge_weight, g.senders, g.receivers, g.x,
                    g.num_nodes_padded)


def preaggregate_input(g: Graph, layer_name: str) -> torch.Tensor:
    """Layer 0's input for a pre-aggregated stack: GCN takes ``Â·X``; SAGE
    and GIN take ``concat([X, agg(X)])``, the aggregate their own layer's
    neighbour mean or sum (the hybrid operator when it carries the layer's
    semantics)."""
    if layer_name == "GCNConv":
        return preaggregate_features(g)
    aggregators = {"SAGEConv": sage_aggregator, "GINConv": gin_aggregator}
    if layer_name not in aggregators:
        raise ValueError(f"pre-aggregation unsupported for {layer_name!r}")
    agg = aggregators[layer_name](g, g.x.dtype)
    return torch.cat([g.x, agg(g.x)], dim=-1)
