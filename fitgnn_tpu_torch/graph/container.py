"""Padded graph container (tensors).

Invariants, as in the JAX package:

* edges are COO sorted by ``receivers`` (ascending), the array analog of CSR;
* padding edges carry ``edge_weight == 0`` and self-loop on the last
  (padding) node ``N_pad - 1``, so weighted aggregations are exact without
  masking;
* the true sizes travel as 0-d tensors ``n_node`` / ``n_edge``.

A ``Graph`` may also hold a stack of same-padded graphs, every tensor with
a leading subgraph axis (``SubgraphBatch.graphs``): the layers then run
on all of them at once, as the JAX package's ``jax.vmap`` over a
``SubgraphBatch`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from fitgnn_tpu_torch.utils.device import to_device


class Graph(NamedTuple):
    """A single padded graph.

    Shapes: ``x: (N_pad, F)``, ``senders/receivers/edge_weight: (E_pad,)``;
    a stack of S graphs puts S in front of each (``n_node``, ``n_edge``:
    (S,)).
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
        """Padded node count of one graph (of each graph of a stack)."""
        return self.x.shape[-2]

    @property
    def edge_mask(self) -> torch.Tensor:
        """(E_pad,) bool, True on real edges (padding edges come last);
        (S, E_pad) for a stack."""
        n_edge = self.n_edge.to(self.senders.device)
        return torch.arange(self.senders.shape[-1],
                            device=self.senders.device) < n_edge[..., None]

    def to(self, device) -> "Graph":
        """The same graph, every tensor (and the operator) on ``device``."""
        return Graph(*(to_device(v, device) for v in self))


class SubgraphBatch(NamedTuple):
    """A stack of same-padded subgraphs, the subgraph axis first.

    ``consume_mask`` marks the nodes whose outputs a subgraph owns (halo
    and cluster-summary nodes are False); ``orig_idx`` maps each padded
    node slot back to its global node id (-1 on padding and summary
    slots).  The split masks are consume-filtered when the batch is built.
    """

    x: torch.Tensor                      # (S, N_pad, F)
    senders: torch.Tensor                # (S, E_pad)
    receivers: torch.Tensor              # (S, E_pad)
    edge_weight: torch.Tensor            # (S, E_pad)
    n_node: torch.Tensor                 # (S,)
    n_edge: torch.Tensor                 # (S,)
    consume_mask: torch.Tensor           # (S, N_pad) bool
    orig_idx: torch.Tensor               # (S, N_pad) int32, -1 = padding
    y: Optional[torch.Tensor] = None             # (S, N_pad) or (S, N_pad, T)
    train_mask: Optional[torch.Tensor] = None    # (S, N_pad)
    val_mask: Optional[torch.Tensor] = None      # (S, N_pad)
    test_mask: Optional[torch.Tensor] = None     # (S, N_pad)

    @property
    def num_subgraphs(self) -> int:
        return self.x.shape[0]

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[-2]

    def graphs(self) -> Graph:
        """Every subgraph at once, as one ``Graph`` with the subgraph axis
        in front (no labels or masks)."""
        return Graph(x=self.x, senders=self.senders, receivers=self.receivers,
                     edge_weight=self.edge_weight, n_node=self.n_node,
                     n_edge=self.n_edge)

    def subgraph(self, i: int) -> Graph:
        """Subgraph ``i`` as a standalone ``Graph`` (views, no copy)."""
        def pick(a):
            return None if a is None else a[i]

        return Graph(x=self.x[i], senders=self.senders[i],
                     receivers=self.receivers[i],
                     edge_weight=self.edge_weight[i], n_node=self.n_node[i],
                     n_edge=self.n_edge[i], y=pick(self.y),
                     train_mask=pick(self.train_mask),
                     val_mask=pick(self.val_mask),
                     test_mask=pick(self.test_mask))

    def slice(self, start: int, stop: int) -> "SubgraphBatch":
        """Subgraphs ``start`` to ``stop`` (views, no copy)."""
        return SubgraphBatch(*(None if v is None else v[start:stop]
                               for v in self))

    def to(self, device) -> "SubgraphBatch":
        """The same batch, every tensor on ``device``."""
        return SubgraphBatch(*(to_device(v, device) for v in self))
