"""Process-group start-up and community placement.

``initialize_distributed`` starts this rank's ``torch.distributed`` process
group: NCCL for a CUDA device, gloo only for the CPU, which a caller asks
for (the tests do); neither falls back to the other.  Give it the
rendezvous (``file://`` or ``tcp://localhost:<port>``), the rank and the
world size, or nothing under ``torchrun`` (``env://``).

``placement_by_community`` is the JAX package's: Leiden communities packed
onto shards so that halo traffic stays inside a host and only summary and
cut traffic crosses hosts (the distributed form of the reference's
community proxy).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize_distributed(device: torch.device,
                           init_method: Optional[str] = None,
                           rank: Optional[int] = None,
                           world_size: Optional[int] = None) -> None:
    """``init_process_group`` for a rank that runs on ``device``: backend
    NCCL on ``cuda`` (``cuda:r`` made the current card first), gloo on
    ``cpu``.  ``init_method`` defaults to ``env://`` (``torchrun`` sets
    the rank and world size there)."""
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is not None:
            torch.cuda.set_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device} (cuda or cpu)")
    kwargs = {} if rank is None else dict(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            **kwargs)


def placement_by_community(labels: np.ndarray, num_shards: int,
                           shards_per_host: int = 1
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy balanced assignment of communities to shards (LPT bin packing),
    communities sorted large-first; returns (node_order, shard_of_node).

    ``node_order`` permutes nodes so each shard's nodes are contiguous (the
    layout ``parallel.shard.shard_graph`` expects via its ``order`` arg);
    within a shard the nodes keep their input order (a stable sort), so at
    one shard it is the identity.
    """
    comms, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(num_shards, dtype=np.int64)
    comm_shard = np.empty(len(comms), dtype=np.int64)
    for ci in order:
        s = int(np.argmin(load))
        comm_shard[ci] = s
        load[s] += counts[ci]

    comm_index = {c: i for i, c in enumerate(comms)}
    shard_of_node = np.array([comm_shard[comm_index[c]] for c in labels],
                             dtype=np.int64)
    node_order = np.argsort(shard_of_node, kind="stable")
    return node_order, shard_of_node
