"""Train and eval steps over the flat data mesh, as the JAX package's
``parallel/dist_train.py``.

Each rank runs the sharded forward (the all-gather or the halo exchange of
the transformed activations, then its local edges), its shard's part of
the global masked loss, and the backward: every rank runs it, because the
exchanges' backward passes are collectives too.  The gradients are summed
over the ranks, so the replicated parameters stay bit-identical, then Adam
with L2 steps on every rank.

A step takes the model and its optimizer (``create_dist_state``), this
rank's node arrays (``ShardedGraph.local``) and its edges: a
``LocalEdges`` (``ShardedGraph.local_edges``, the all-gather table) or a
``LocalHaloPlan`` (``HaloPlan.local``, the halo table).  The ``make_*``
forms bind the model (and the plan) to a mesh's data group, as the JAX
package's bind them to its mesh.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from fitgnn_tpu_torch.parallel.collectives import (all_reduce_grads,
                                                   all_reduce_sum)
from fitgnn_tpu_torch.parallel.halo import LocalHaloPlan
from fitgnn_tpu_torch.parallel.shard import LocalShard
from fitgnn_tpu_torch.train.losses import (task_loss_sums,
                                           task_metric_from_sums,
                                           task_metric_sums)
from fitgnn_tpu_torch.train.steps import adam_l2
from fitgnn_tpu_torch.utils.device import resolve_device


class DistState(NamedTuple):
    """The replicated parameters (the model's) and Adam's state."""

    model: nn.Module
    opt: torch.optim.Optimizer


def _model_task(model) -> str:
    """Classification when the head ends in log_softmax, else regression
    (the reference trains node_reg through the same runners)."""
    return "classification" if model.classify else "regression"


def create_dist_state(model: nn.Module, seed: int, device="cuda",
                      lr: float = 0.01,
                      weight_decay: float = 5e-4) -> DistState:
    """flax's default init drawn from a ``torch.Generator`` seeded with
    ``seed`` (the same parameters on every rank), the model moved to
    ``device`` and Adam with L2 over its parameters."""
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(resolve_device(str(device)))
    return DistState(model, adam_l2(model.parameters(), lr, weight_decay))


def _forward(model, x, edges, group, generator=None) -> torch.Tensor:
    """The model on this rank's rows over ``edges``' table."""
    return model(x, edges.senders, edges.receivers, edges.edge_weight,
                 getattr(edges, "send_idx", None),
                 getattr(edges, "send_mask", None), group, generator)


def dist_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    shard: LocalShard, edges,
                    generator: Optional[torch.Generator] = None,
                    group=None) -> torch.Tensor:
    """One full-batch step over ``group`` (None: the default group): the
    loss is this rank's masked sum over the count of every rank (at least
    1), the gradients and the loss are summed over the ranks.  Dropout
    draws from ``generator``, seeded alike on every rank.  Returns the
    summed loss."""
    model.train()
    opt.zero_grad(set_to_none=True)
    out = _forward(model, shard.x, edges, group, generator)
    local_sum, local_cnt = task_loss_sums(_model_task(model), out, shard.y,
                                          shard.train_mask)
    loss = local_sum / all_reduce_sum(local_cnt, group).clamp_min(1.0)
    loss.backward()
    all_reduce_grads(model.parameters(), group)
    opt.step()
    return all_reduce_sum(loss, group)


def halo_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                    shard: LocalShard, plan: LocalHaloPlan,
                    generator: Optional[torch.Generator] = None,
                    group=None) -> torch.Tensor:
    """``dist_train_step`` over the halo table: the same loss and
    gradients, the layers' exchange moving only boundary rows.  ``model``
    is a ``DistNodeModelHalo`` or the all-gather ``DistNodeModel`` itself
    (the same parameters)."""
    if not isinstance(plan, LocalHaloPlan):
        raise TypeError(f"halo_train_step takes a LocalHaloPlan, not "
                        f"{type(plan).__name__}")
    return dist_train_step(model, opt, shard, plan, generator, group)


def dist_eval_step(model: nn.Module, shard: LocalShard, edges,
                   split: str = "test", group=None) -> tuple:
    """(loss, metric) over every rank's ``split`` rows (``val`` or
    ``test``) from the five all-reduced sums: accuracy, or the L1 over
    the std of the targets of every rank together."""
    model.eval()
    mask = shard.val_mask if split == "val" else shard.test_mask
    task = _model_task(model)
    with torch.no_grad():
        out = _forward(model, shard.x, edges, group)
        sums = torch.stack([v.float().reshape(()) for v in (
            *task_loss_sums(task, out, shard.y, mask),
            *task_metric_sums(task, out, shard.y, mask))])
        ls, c, ms, ys, y2s = all_reduce_sum(sums, group)
        metric = task_metric_from_sums(task, ls, c, ms, ys, y2s)
        return ls / c.clamp_min(1.0), metric


def make_dist_train_step(mesh, model: nn.Module):
    """``step(opt, shard, edges, generator=None) -> loss`` over the mesh's
    data group."""
    def step(opt, shard, edges, generator=None):
        return dist_train_step(model, opt, shard, edges, generator,
                               mesh.chip_group)
    return step


def make_halo_train_step(mesh, model: nn.Module, plan: LocalHaloPlan):
    """``step(opt, shard, generator=None) -> loss`` over this rank's halo
    plan and the mesh's data group."""
    def step(opt, shard, generator=None):
        return halo_train_step(model, opt, shard, plan, generator,
                               mesh.chip_group)
    return step


def make_dist_eval_step(mesh, model: nn.Module, split: str = "test"):
    """``step(shard, edges) -> (loss, metric)`` over the mesh's data
    group."""
    def step(shard, edges):
        return dist_eval_step(model, shard, edges, split, mesh.chip_group)
    return step
