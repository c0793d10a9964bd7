"""Message-passing layers on the port's SpMM ops.

GCNConv: symmetric D^-1/2 (A+I) D^-1/2 aggregation of W·x (+bias).  The
normalized weights are precomputed in ``graph.build``, so the layer is one
dense matmul + one weighted SpMM.  SAGE, GIN and GAT come with later slices.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fitgnn_tpu_torch.graph.container import Graph
from fitgnn_tpu_torch.ops.hybrid_spmm import HybridSpmm, hybrid_spmm
from fitgnn_tpu_torch.ops.spmm import spmm_coo

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


def make_layer(layer_name: str, in_features: int, hidden: int) -> nn.Module:
    if layer_name == "GCNConv":
        return GCNConv(in_features, hidden)
    raise NotImplementedError(
        f"layer {layer_name!r} is not ported yet (ROADMAP.md §1: SAGE/GIN "
        "with the training slice, GAT with its own slice)")
