"""Row-parallel layers and node models over the flat data mesh, as the JAX
package's ``parallel/dist_model.py``.

One rank holds one shard: its nodes' features and every edge whose
receiver it owns, with the senders either global (the all-gather table)
or remapped into ``concat([local rows, halo rows])`` (the halo table of
``parallel/halo.py``).  Before each aggregation a layer exchanges its
*transformed* activations at ``features`` width, then sums its local
incoming edges with a per-edge gather and ``segment_sum``, in plain
PyTorch as the JAX package's is in XLA: no kernel of the port runs here.

Each layer subclasses the single-device layer of ``models/layers.py`` and
each model ``NodeModel``, so the parameter names and shapes are the
single-device model's (``convs.layers.<i>.*``, ``head.*``): one state dict
loads into ``NodeModel``, ``DistNodeModel`` and ``DistNodeModelHalo``
unchanged, and ``models.convert.params_from_flax`` carries the JAX
package's ``DistNodeModel`` parameters across.  Every layer takes
``send_idx=None`` for the all-gather table and this rank's (P, K) halo
slices for the halo table, so one model runs either exchange.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fitgnn_tpu_torch.models.layers import (GATConv, GCNConv, GINConv,
                                            SAGEConv)
from fitgnn_tpu_torch.models.models import ConvStack, NodeModel
from fitgnn_tpu_torch.ops.segment import (segment_softmax, segment_sum,
                                          take_rows)
from fitgnn_tpu_torch.parallel.collectives import all_gather_rows
from fitgnn_tpu_torch.parallel.halo import halo_exchange


def _sender_table(h_local: torch.Tensor, group, send_idx,
                  send_mask) -> torch.Tensor:
    """The table sender indices point into: the full all-gather when no
    halo slices are given, else ``concat([local rows, halo rows])``."""
    if send_idx is None:
        return all_gather_rows(h_local, group)
    return torch.cat([h_local, halo_exchange(h_local, send_idx, send_mask,
                                             group)])


def _aggregate(table: torch.Tensor, senders: torch.Tensor,
               receivers: torch.Tensor, edge_weight: torch.Tensor,
               n_loc: int) -> torch.Tensor:
    return segment_sum(take_rows(table, senders)
                       * edge_weight[:, None].to(table.dtype),
                       receivers, n_loc)


class DistGCNConv(GCNConv):
    """GCN over a node-sharded graph: ``lin`` first (no bias), the
    transformed rows exchanged, aggregated with the edge weights, then the
    bias."""

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None):
        h = self.lin(x_local)
        table = _sender_table(h, group, send_idx, send_mask)
        out = _aggregate(table, senders, receivers_local, edge_weight,
                         x_local.shape[0])
        return out + self.bias


class DistGCNConvHalo(DistGCNConv):
    """``DistGCNConv`` on the halo table alone: the same parameters, so the
    two are interchangeable layer by layer."""

    def forward(self, x_local, senders_ext, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None):
        if send_idx is None:
            raise ValueError("DistGCNConvHalo needs the halo plan's "
                             "send_idx and send_mask")
        return super().forward(x_local, senders_ext, receivers_local,
                               edge_weight, send_idx, send_mask, group)


class DistSAGEConv(SAGEConv):
    """SAGE over a sharded graph, the edge weights SAGE's neighbour-mean
    weights (``shard.LAYER_SEMANTICS['SAGEConv']``): the transformed rows
    exchanged, with ``lin_l``'s bias pulled out of the mean as
    ``b_l = lin_l(0)`` so that a node without neighbours still gets it."""

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None):
        b_l = self.lin_l(x_local.new_zeros(1, x_local.shape[-1]))
        h = self.lin_l(x_local) - b_l
        table = _sender_table(h, group, send_idx, send_mask)
        mean = _aggregate(table, senders, receivers_local, edge_weight,
                          x_local.shape[0])
        return mean + b_l + self.lin_r(x_local)


class DistGINConv(GINConv):
    """GIN over a sharded graph, the edge weights the unit non-self-edge
    weights (``sum_nonself``): W₀((1+ε)x + Σx) + b₀ = (1+ε)h₀ + Σh₀ + b₀
    with h₀ = x·W₀, so the transformed rows are exchanged."""

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None):
        b0 = self.mlp_0(x_local.new_zeros(1, x_local.shape[-1]))
        h0 = self.mlp_0(x_local) - b0
        table = _sender_table(h0, group, send_idx, send_mask)
        s = _aggregate(table, senders, receivers_local, edge_weight,
                       x_local.shape[0])
        h = F.relu((1.0 + self.eps).to(h0.dtype) * h0 + s + b0)
        return F.relu(self.mlp_1(h))


class DistGATConv(GATConv):
    """Single-head GAT over a sharded graph.  A rank owns every incoming
    edge of its nodes, so the per-receiver softmax is exact; only the
    transformed rows are exchanged, and the senders' scores are recomputed
    per edge from the received rows.  ``edge_weight > 0`` is the real-edge
    mask (``att_unit``: unit weights, self loops included)."""

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None):
        n_loc = x_local.shape[0]
        f32 = torch.float32
        h = self.lin(x_local)
        table = _sender_table(h, group, send_idx, send_mask)
        y = take_rows(table, senders)                          # (E, C)
        ssrc = y.to(f32) @ self.att_src[0].to(f32)             # (E,)
        sdst_e = take_rows(h.to(f32) @ self.att_dst[0].to(f32),
                           receivers_local)
        pre = F.leaky_relu(ssrc + sdst_e, self.negative_slope)
        alpha = segment_softmax(pre, receivers_local, n_loc,
                                mask=edge_weight > 0)
        out = segment_sum(y * alpha[:, None].to(y.dtype), receivers_local,
                          n_loc)
        return out + self.bias.to(f32).to(out.dtype)


#: the layers whose one class serves both tables
DIST_LAYER_REGISTRY = {
    "SAGEConv": DistSAGEConv,
    "GINConv": DistGINConv,
    "GATConv": DistGATConv,
}


def make_dist_conv(layer_name: str, in_features: int, features: int,
                   halo: bool) -> nn.Module:
    """Layer factory of the stacks (the reference's layer selection); GCN
    keeps its two classes, the halo one refusing the all-gather table."""
    if layer_name == "GCNConv":
        cls = DistGCNConvHalo if halo else DistGCNConv
        return cls(in_features, features)
    if layer_name not in DIST_LAYER_REGISTRY:
        raise ValueError(f"unknown dist layer {layer_name!r}; choose from "
                         f"{['GCNConv'] + sorted(DIST_LAYER_REGISTRY)}")
    return DIST_LAYER_REGISTRY[layer_name](in_features, features)


class DistConvStack(ConvStack):
    """``num_layers`` dist convs, each followed by ELU and, in train mode,
    ``ConvStack``'s dropout (bit dropout at rate ½, else Bernoulli) drawn
    from the caller's generator."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, dropout_rate: float = 0.5,
                 halo: bool = False):
        nn.Module.__init__(self)
        self.layers = nn.ModuleList(
            make_dist_conv(layer_name, in_dim if i == 0 else hidden, hidden,
                           halo)
            for i in range(num_layers))
        self.dropout_rate = dropout_rate
        self.fused_dropout = False
        self.bit_dropout = True

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None,
                generator: Optional[torch.Generator] = None):
        drop = self.training and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("DistConvStack: train-mode dropout needs an "
                             "explicit torch.Generator")
        for layer in self.layers:
            x_local = F.elu(layer(x_local, senders, receivers_local,
                                  edge_weight, send_idx, send_mask, group))
            if drop:
                x_local = self._dropout(x_local, generator)
        return x_local


class DistNodeModel(NodeModel):
    """``NodeModel`` over one rank's shard: the same parameter names and
    shapes; the layer selected by name.  ``forward`` takes the all-gather
    table's global senders, or the halo table's remapped senders with
    this rank's ``send_idx`` / ``send_mask``."""

    halo = False

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True,
                 dropout_rate: float = 0.5):
        nn.Module.__init__(self)
        self.classify = classify
        self.convs = DistConvStack(layer_name, in_dim, hidden, num_layers,
                                   dropout_rate, self.halo)
        self.head = nn.Linear(hidden, out_dim)

    def forward(self, x_local, senders, receivers_local, edge_weight,
                send_idx=None, send_mask=None, group=None,
                generator: Optional[torch.Generator] = None):
        """Log-probs (classification) or the raw scalar of this rank's
        rows; ``group`` the data group (None: the default group)."""
        out = self.head(self.convs(x_local, senders, receivers_local,
                                   edge_weight, send_idx, send_mask, group,
                                   generator))
        if self.classify:
            return F.log_softmax(out.float(), dim=-1)
        return out.float()


class DistNodeModelHalo(DistNodeModel):
    """``DistNodeModel`` on the halo table (GCN's layers are
    ``DistGCNConvHalo``); its state dict is ``DistNodeModel``'s."""

    halo = True
