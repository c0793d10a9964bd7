"""The distributed paths on ``torch.distributed``: one rank a shard
(``mesh``, ``multihost``), the differentiable exchanges (``collectives``),
host-side sharding (``shard``) and the hierarchical layer
(``hierarchical``), behind ``train --baseline --num_devices N``, and the
subgraph-axis Gs steps (``dist_subgraphs``) that, with the hierarchical
Gc phase, run the distributed curriculum (``train --num_devices N``)."""

from fitgnn_tpu_torch.parallel.dist_subgraphs import (
    dist_gs_eval_step, dist_gs_train_epoch_mb, dist_gs_train_step_gd,
    pad_batch_to_shards, shard_batches)
from fitgnn_tpu_torch.parallel.hierarchical import (
    HierNodeModel, HierPlan, RankPlan, build_hier_plan, hier_aggregate,
    hier_attention_aggregate, hier_eval_step, hier_oracle_features,
    hier_train_step, hier_view, init_hier_params)
from fitgnn_tpu_torch.parallel.mesh import (CHIP_AXIS, DATA_AXIS, HOST_AXIS,
                                            HierMesh, chips_per_host,
                                            make_hier_mesh)
from fitgnn_tpu_torch.parallel.multihost import (initialize_distributed,
                                                 placement_by_community)
from fitgnn_tpu_torch.parallel.shard import (LAYER_SEMANTICS, LocalShard,
                                             ShardedGraph, shard_graph,
                                             shard_node_array,
                                             shard_prebuilt_graph)

__all__ = [
    "CHIP_AXIS", "DATA_AXIS", "HOST_AXIS", "HierMesh", "chips_per_host",
    "make_hier_mesh", "initialize_distributed",
    "placement_by_community", "LAYER_SEMANTICS", "LocalShard",
    "ShardedGraph", "shard_graph", "shard_node_array",
    "shard_prebuilt_graph", "HierNodeModel", "HierPlan", "RankPlan",
    "build_hier_plan", "hier_aggregate", "hier_attention_aggregate",
    "hier_eval_step", "hier_oracle_features", "hier_train_step",
    "hier_view", "init_hier_params", "dist_gs_eval_step",
    "dist_gs_train_epoch_mb", "dist_gs_train_step_gd",
    "pad_batch_to_shards", "shard_batches",
]
