"""The rank layout of the distributed paths.

The JAX package runs P shards as P devices of one process under
``shard_map``, on a 1-D ``data`` mesh or a 2-D (``host`` × ``chip``) mesh.
In the port one rank is one shard, and each mesh axis is a set of
``torch.distributed`` process groups:

* shard ``p`` sits at host ``p // D``, chip ``p % D`` (the JAX package's
  ``HierPlan`` layout, D chips a host);
* a **chip group** is the D ranks of one host, in chip order: the halo
  exchange runs over it (the JAX package's ``chip`` axis);
* a **host group** is the H ranks that share a chip index, in host order:
  the summaries' second gather runs over it (the ``host`` axis).

The flat ``data`` mesh of the all-gather and halo layers (``make_mesh``)
is the (1 × P) mesh: its chip group holds every rank, in rank order.

``torch.distributed.new_group`` must be called by every rank in the same
order, so every rank creates every group, chip groups first.
"""

from __future__ import annotations

import dataclasses

import torch.distributed as dist

DATA_AXIS = "data"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def chips_per_host(num_devices: int, num_hosts: int) -> int:
    """D = P / H, refused with the JAX package's message when H does not
    divide P."""
    if num_hosts < 1 or num_devices % num_hosts != 0:
        raise ValueError(f"--num_devices {num_devices} must divide by "
                         f"--num_hosts {num_hosts}")
    return num_devices // num_hosts


@dataclasses.dataclass(frozen=True)
class HierMesh:
    """One rank's view of an (H × D) mesh: its place and its two groups."""

    num_hosts: int
    chips_per_host: int
    rank: int
    chip_group: object          # the D ranks of this rank's host
    host_group: object          # the H ranks of this rank's chip index


def make_hier_mesh(num_hosts: int, chips_per_host: int) -> HierMesh:
    """The (H × D) mesh over an initialized process group of exactly H·D
    ranks (``parallel.multihost.initialize_distributed``)."""
    P = num_hosts * chips_per_host
    world = dist.get_world_size()
    if world != P:
        raise ValueError(f"need {P} ranks, the process group has {world}")
    rank = dist.get_rank()
    chip_groups = [dist.new_group([h * chips_per_host + d
                                   for d in range(chips_per_host)])
                   for h in range(num_hosts)]
    host_groups = [dist.new_group([h * chips_per_host + d
                                   for h in range(num_hosts)])
                   for d in range(chips_per_host)]
    return HierMesh(num_hosts, chips_per_host, rank,
                    chip_groups[rank // chips_per_host],
                    host_groups[rank % chips_per_host])


def make_mesh(num_devices: int | None = None) -> HierMesh:
    """The flat ``data`` mesh over an initialized process group of exactly
    ``num_devices`` ranks (default: the whole world): an H = 1
    ``HierMesh`` whose ``chip_group`` is the data axis."""
    if num_devices is None:
        num_devices = dist.get_world_size()
    return make_hier_mesh(1, num_devices)
