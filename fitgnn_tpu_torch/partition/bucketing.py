"""Size-bucketed subgraph batches, as the JAX package's
``partition/bucketing.py`` builds them.

One pad for every subgraph (``pad_subgraphs``) pads each to the largest.
Bucketing groups the subgraphs by their node count rounded up to a power
of two (at least ``min_bucket``) and pads each group on its own, so a
subgraph is padded to at most twice its size.  The union of consuming
nodes over the buckets is the same exact cover as one pad's.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from fitgnn_tpu_torch.graph.container import SubgraphBatch
from fitgnn_tpu_torch.partition.subgraphs import SubgraphSpec, pad_subgraphs


def bucket_subgraphs(
    specs: Sequence[SubgraphSpec],
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    min_bucket: int = 32,
    **pad_kwargs,
) -> List[SubgraphBatch]:
    """The batches of ``bucket_subgraphs_with_index``, in ascending cap
    order."""
    batches, _ = bucket_subgraphs_with_index(
        specs, y=y, train_mask=train_mask, val_mask=val_mask,
        test_mask=test_mask, min_bucket=min_bucket, **pad_kwargs)
    return batches


def bucket_subgraphs_with_index(
    specs: Sequence[SubgraphSpec],
    y: Optional[np.ndarray] = None,
    train_mask: Optional[np.ndarray] = None,
    val_mask: Optional[np.ndarray] = None,
    test_mask: Optional[np.ndarray] = None,
    min_bucket: int = 32,
    max_buckets: int = 0,
    **pad_kwargs,
):
    """``(batches, index)``: one padded ``SubgraphBatch`` per size cap, in
    ascending cap order, and ``index[i] = (bucket, position)`` of spec
    ``i``, so that callers addressing a subgraph by its metanode id (the
    ``parent`` map, inference sampling) find it.

    ``max_buckets > 0`` caps the number of buckets: adjacent cap groups
    merge greedily, each time the pair whose merge adds the least padding.
    A group's members already sit at its current cap, so merging group j
    into j + 1 adds ``cap_{j+1} - cap_j`` node slots per member of j."""
    if max_buckets < 0:
        raise ValueError(f"max_buckets must be >= 0, got {max_buckets}")
    sizes = np.array([s.num_nodes for s in specs])
    caps = np.maximum(
        min_bucket,
        2 ** np.ceil(np.log2(np.maximum(sizes, 1))).astype(np.int64))
    uniq = list(np.unique(caps))
    if max_buckets and len(uniq) > max_buckets:
        counts = {c: int((caps == c).sum()) for c in uniq}
        groups = [[c] for c in uniq]
        while len(groups) > max_buckets:
            waste = [(groups[j + 1][-1] - groups[j][-1])
                     * sum(counts[c] for c in groups[j])
                     for j in range(len(groups) - 1)]
            j = int(np.argmin(waste))
            groups[j + 1] = groups[j] + groups[j + 1]
            del groups[j]
        remap = {c: g[-1] for g in groups for c in g}
        caps = np.array([remap[c] for c in caps])
        uniq = [g[-1] for g in groups]
    batches: List[SubgraphBatch] = []
    index = np.zeros((len(specs), 2), dtype=np.int64)
    for b, cap in enumerate(uniq):
        sel = np.flatnonzero(caps == cap)
        index[sel, 0] = b
        index[sel, 1] = np.arange(len(sel))
        batches.append(pad_subgraphs(
            [specs[i] for i in sel], y=y, train_mask=train_mask,
            val_mask=val_mask, test_mask=test_mask, **pad_kwargs))
    return batches, index
