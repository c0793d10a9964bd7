"""Node-task model: conv stack + dense head.

``NodeModel`` is the JAX package's ``NodeModel`` (convs → dense head;
log_softmax for classification, the raw scalar for regression).  Dropout
runs only in train mode (``model.train()``) and draws from a
``torch.Generator`` the caller passes to ``forward``, never from torch's
global generator; eval mode (the serve path) has no dropout.  The dropout
of a layer follows the JAX package's precedence: the byte-mask dropout at
rate ½ under ``bit_dropout`` (the default), else the in-kernel Philox
dropout (K11, ``ops/dropout.py``) under ``fused_dropout``, else Bernoulli
dropout from a uniform draw.  The JAX package's layer-0 pre-aggregation is
not ported yet (ROADMAP.md §1 item 2).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from fitgnn_tpu_torch.graph.container import Graph
from fitgnn_tpu_torch.models.layers import lecun_normal_, make_layer
from fitgnn_tpu_torch.ops.dropout import fused_dropout, seed_from_generator


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


class ConvStack(nn.Module):
    """``num_layers`` convs, each followed by ELU and, in train mode,
    dropout(``dropout_rate``): bit dropout when ``bit_dropout`` and the rate
    is ½, else K11 when ``fused_dropout`` (one seed a layer, drawn from the
    generator), else Bernoulli dropout."""

    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, dropout_rate: float = 0.5,
                 fused_dropout: bool = False, bit_dropout: bool = True):
        super().__init__()
        self.layers = nn.ModuleList(
            make_layer(layer_name, in_dim if i == 0 else hidden, hidden)
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

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        drop = self.training and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("ConvStack: train-mode dropout needs an explicit "
                             "torch.Generator")
        for layer in self.layers:
            x = F.elu(layer(x, g))
            if drop:
                x = self._dropout(x, generator)
        return x


class NodeModel(nn.Module):
    def __init__(self, layer_name: str, in_dim: int, hidden: int,
                 num_layers: int, out_dim: int, classify: bool = True,
                 dropout_rate: float = 0.5, fused_dropout: bool = False,
                 bit_dropout: bool = True):
        super().__init__()
        self.classify = classify
        self.convs = ConvStack(layer_name, in_dim, hidden, num_layers,
                               dropout_rate, fused_dropout, bit_dropout)
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

    def forward(self, x: torch.Tensor, g: Graph,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Log-probs (classification) or the raw scalar; ``generator``
        drives the dropout masks in train mode."""
        out = self.head(self.convs(x, g, generator))
        if self.classify:
            return F.log_softmax(out.float(), dim=-1)
        return out.float()
