"""The distributed paths on ``torch.distributed``: one rank a shard
(``mesh``, ``multihost``), the differentiable exchanges (``collectives``),
host-side sharding (``shard``); the flat data mesh's all-gather and halo
layers and their steps (``halo``, ``dist_model``, ``dist_train``,
library surface that ``scripts/torch_scaling_bench.py`` drives); the
hierarchical layer (``hierarchical``), behind ``train --baseline
--num_devices N``, and the subgraph-axis Gs steps (``dist_subgraphs``)
that, with the hierarchical Gc phase, run the distributed curriculum
(``train --num_devices N``).  ``halo_exchange`` here is the flat mesh's
(``halo.halo_exchange``); the hierarchical layer's is
``collectives.halo_exchange``."""

from fitgnn_tpu_torch.parallel.dist_model import (
    DIST_LAYER_REGISTRY, DistConvStack, DistGATConv, DistGCNConv,
    DistGCNConvHalo, DistGINConv, DistNodeModel, DistNodeModelHalo,
    DistSAGEConv, make_dist_conv)
from fitgnn_tpu_torch.parallel.dist_subgraphs import (
    dist_gs_eval_step, dist_gs_train_epoch_mb, dist_gs_train_step_gd,
    pad_batch_to_shards, shard_batches)
from fitgnn_tpu_torch.parallel.dist_train import (
    DistState, create_dist_state, dist_eval_step, dist_train_step,
    halo_train_step, make_dist_eval_step, make_dist_train_step,
    make_halo_train_step)
from fitgnn_tpu_torch.parallel.halo import (HaloPlan, LocalHaloPlan,
                                            build_halo_plan, halo_exchange)
from fitgnn_tpu_torch.parallel.hierarchical import (
    HierNodeModel, HierPlan, RankPlan, build_hier_plan, hier_aggregate,
    hier_attention_aggregate, hier_eval_step, hier_oracle_features,
    hier_train_step, hier_view, init_hier_params)
from fitgnn_tpu_torch.parallel.mesh import (CHIP_AXIS, DATA_AXIS, HOST_AXIS,
                                            HierMesh, chips_per_host,
                                            make_hier_mesh, make_mesh)
from fitgnn_tpu_torch.parallel.multihost import (initialize_distributed,
                                                 placement_by_community)
from fitgnn_tpu_torch.parallel.shard import (LAYER_SEMANTICS, LocalEdges,
                                             LocalShard, ShardedGraph,
                                             shard_graph, shard_node_array,
                                             shard_prebuilt_graph)

__all__ = [
    "CHIP_AXIS", "DATA_AXIS", "HOST_AXIS", "HierMesh", "chips_per_host",
    "make_hier_mesh", "make_mesh", "initialize_distributed",
    "placement_by_community", "LAYER_SEMANTICS", "LocalEdges", "LocalShard",
    "ShardedGraph", "shard_graph", "shard_node_array",
    "shard_prebuilt_graph", "HaloPlan", "LocalHaloPlan", "build_halo_plan",
    "halo_exchange", "DIST_LAYER_REGISTRY", "DistConvStack", "DistGATConv",
    "DistGCNConv", "DistGCNConvHalo", "DistGINConv", "DistNodeModel",
    "DistNodeModelHalo", "DistSAGEConv", "make_dist_conv", "DistState",
    "create_dist_state", "dist_eval_step", "dist_train_step",
    "halo_train_step", "make_dist_eval_step", "make_dist_train_step",
    "make_halo_train_step", "HierNodeModel", "HierPlan", "RankPlan",
    "build_hier_plan", "hier_aggregate", "hier_attention_aggregate",
    "hier_eval_step", "hier_oracle_features", "hier_train_step",
    "hier_view", "init_hier_params", "dist_gs_eval_step",
    "dist_gs_train_epoch_mb", "dist_gs_train_step_gd",
    "pad_batch_to_shards", "shard_batches",
]
