"""Node-task model: conv stack + dense head.

``NodeModel`` is the JAX package's ``NodeModel`` (convs → dense head;
log_softmax for classification, the raw scalar for regression).  Dropout
is inactive in eval mode, which is what the serve path runs; the JAX
package's training-time dropout variants and layer-0 pre-aggregation come
with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from fitgnn_tpu_torch.graph.container import Graph
from fitgnn_tpu_torch.models.layers import lecun_normal_, make_layer


class ConvStack(nn.Module):
    """``num_layers`` convs, each followed by ELU + dropout(0.5)."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int):
        super().__init__()
        self.layers = nn.ModuleList(
            make_layer(layer_name, in_dim if i == 0 else hidden, hidden)
            for i in range(num_layers))
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        for layer in self.layers:
            x = self.dropout(F.elu(layer(x, g)))
        return x


class NodeModel(nn.Module):
    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True):
        super().__init__()
        self.classify = classify
        self.convs = ConvStack(layer_name, in_dim, hidden, num_layers)
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

    def forward(self, x: torch.Tensor, g: Graph) -> torch.Tensor:
        out = self.head(self.convs(x, g))
        if self.classify:
            return F.log_softmax(out.float(), dim=-1)
        return out.float()
