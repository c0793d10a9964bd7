"""Peak data-memory audit: the byte footprint of the full graph against
the largest subgraph, as the JAX package's ``bench/memory.py`` reports it
(the reference's "FIT in memory" evidence).  Two numbers per object:

* ``real_mb``: bytes of the true (unpadded) node and edge payload;
* ``padded_mb``: bytes of the padded buffers one subgraph's bucket slot
  holds on the device.

Both come from shapes and true counts alone, so they are the JAX
package's numbers wherever the port pads a partition as it does (the same
``num_nodes_padded``, edge width ``senders.shape[-1]`` and buckets).
"""

from __future__ import annotations

import dataclasses
from typing import List

from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch


def _mb(n_bytes: float) -> float:
    return n_bytes / (1024 * 1024)


@dataclasses.dataclass
class MemoryRow:
    kind: str            # "full_graph" | "max_subgraph"
    real_mb: float
    padded_mb: float


def graph_bytes(num_nodes: int, num_edges: int, feat: int,
                with_labels: bool = True) -> float:
    """float32 features + int32 edge endpoints + float32 weights + labels
    (8 bytes a node), the JAX package's accounting."""
    b = num_nodes * feat * 4.0 + num_edges * (4 + 4 + 4.0)
    if with_labels:
        b += num_nodes * 8.0
    return b


def full_graph_memory(g: Graph) -> MemoryRow:
    feat = g.x.shape[1]
    real = graph_bytes(int(g.n_node), int(g.n_edge), feat)
    padded = graph_bytes(g.num_nodes_padded, g.senders.shape[-1], feat)
    return MemoryRow("full_graph", _mb(real), _mb(padded))


def max_subgraph_memory(batch: SubgraphBatch) -> MemoryRow:
    feat = batch.x.shape[-1]
    n_nodes = batch.n_node.cpu().tolist()
    n_edges = batch.n_edge.cpu().tolist()
    real = max(graph_bytes(int(n), int(e), feat)
               for n, e in zip(n_nodes, n_edges))
    padded = graph_bytes(batch.num_nodes_padded, batch.senders.shape[-1],
                         feat)
    return MemoryRow("max_subgraph", _mb(real), _mb(padded))


def memory_report(g: Graph, batch) -> List[MemoryRow]:
    """``batch``: one ``SubgraphBatch`` or a sequence of bucketed batches
    (the max-subgraph row then maximizes across buckets; its padded number
    is the max subgraph's own bucket slot, not the largest pad)."""
    if isinstance(batch, SubgraphBatch):
        return [full_graph_memory(g), max_subgraph_memory(batch)]
    rows = [max_subgraph_memory(b) for b in batch]
    best = max(rows, key=lambda r: r.real_mb)
    return [full_graph_memory(g), best]
