"""Padded graph container (tensors).

Invariants, as in the JAX package:

* edges are COO sorted by ``receivers`` (ascending), the array analog of CSR;
* padding edges carry ``edge_weight == 0`` and self-loop on the last
  (padding) node ``N_pad - 1``, so weighted aggregations are exact without
  masking;
* the true sizes travel as 0-d tensors ``n_node`` / ``n_edge``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fitgnn_tpu_torch.utils.device import to_device


class Graph(NamedTuple):
    """A single padded graph.

    Shapes: ``x: (N_pad, F)``, ``senders/receivers/edge_weight: (E_pad,)``.
    """

    x: torch.Tensor                      # (N_pad, F) node features
    senders: torch.Tensor                # (E_pad,) int32 source per edge
    receivers: torch.Tensor              # (E_pad,) int32 dest (sorted)
    edge_weight: torch.Tensor            # (E_pad,) float32; 0 on padding
    n_node: torch.Tensor                 # () int32 true node count
    n_edge: torch.Tensor                 # () int32 true edge count
    y: Optional[torch.Tensor] = None     # (N_pad,) labels / (N_pad, T)
    train_mask: Optional[torch.Tensor] = None   # (N_pad,) bool
    val_mask: Optional[torch.Tensor] = None     # (N_pad,) bool
    test_mask: Optional[torch.Tensor] = None    # (N_pad,) bool
    aux: Optional[object] = None         # precomputed operator structure
                                         # (ops.hybrid_spmm.HybridSpmm)

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[0]

    @property
    def edge_mask(self) -> torch.Tensor:
        """(E_pad,) bool, True on real edges (padding edges come last)."""
        return torch.arange(self.senders.shape[0],
                            device=self.senders.device) < self.n_edge.to(
                                self.senders.device)

    def to(self, device) -> "Graph":
        """The same graph, every tensor (and the operator) on ``device``."""
        return Graph(*(to_device(v, device) for v in self))
