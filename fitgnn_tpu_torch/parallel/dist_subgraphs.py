"""Data parallelism over the subgraph axis: the FIT-GNN Gs phase sharded
over the ranks of a process group, as the JAX package's
``parallel/dist_subgraphs.py`` shards a padded ``SubgraphBatch`` over its
``data`` mesh axis.

The JAX package hands device ``d`` subgraphs ``[d·S/P, (d+1)·S/P)`` of
each bucket (``shard_map``'s ``P(DATA_AXIS)``) after padding S to a
multiple of P with empty subgraphs; here rank ``d`` holds that slice
(``shard_batches``), and only it moves to the rank's device.  Each rank
runs the model on its slice; the masked loss is its local sum over the
train count of every rank, so the summed gradients are those of the
global masked mean, and every rank takes the same optimizer step:

* ``dist_gs_train_step_gd``: one step over every bucket (the backward
  bucket by bucket, as ``steps.gs_train_step_gd_multi``);
* ``dist_gs_train_epoch_mb``: one step per global chunk of subgraphs,
  local chunk ``k`` of every rank forming global chunk ``k``; a chunk
  with no train node on any rank is skipped by every rank;
* ``dist_gs_eval_step``: the five eval sums of every bucket, summed over
  the ranks, then the loss and metric.

``loss_reduction`` and ``eval_chunk`` are not read here: the JAX
package's distributed steps read neither (the loss is always the masked
mean, the eval never chunked).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from fitgnn_tpu_torch.graph.container import SubgraphBatch
from fitgnn_tpu_torch.parallel.collectives import (all_reduce_grads,
                                                   all_reduce_sum)
from fitgnn_tpu_torch.train.losses import (task_loss_sums,
                                           task_metric_from_sums)
from fitgnn_tpu_torch.train.steps import (chunk_pad, gs_eval_bucket_sums,
                                          pad_subgraphs)


def pad_batch_to_shards(batch: SubgraphBatch,
                        num_shards: int) -> SubgraphBatch:
    """Pad the subgraph axis to a multiple of ``num_shards`` with empty
    subgraphs (``steps.pad_subgraphs``)."""
    s = batch.num_subgraphs
    return pad_subgraphs(batch, -(-s // num_shards) * num_shards - s)


def shard_batches(batches: Sequence[SubgraphBatch], rank: int,
                  num_shards: int, device=None) -> tuple:
    """Rank ``rank``'s slice of each batch padded to ``num_shards``
    shards, moved to ``device``."""
    out = []
    for b in batches:
        b = pad_batch_to_shards(b, num_shards)
        n = b.num_subgraphs // num_shards
        out.append(b.slice(rank * n, (rank + 1) * n).to(device))
    return tuple(out)


def dist_gs_train_step_gd(model: torch.nn.Module,
                          opt: torch.optim.Optimizer,
                          batches: Sequence[SubgraphBatch],
                          generator: Optional[torch.Generator], task: str,
                          group=None) -> torch.Tensor:
    """One update from the masked mean over every bucket's train nodes on
    every rank (``make_dist_gs_train_step_multi``): the train count is
    summed over the ranks before the forward, each bucket's local sum over
    it runs its backward in turn, the gradients are summed over the ranks,
    then the optimizer steps.  Returns the loss summed over the ranks."""
    model.train()
    opt.zero_grad(set_to_none=True)
    count = all_reduce_sum(
        sum(b.train_mask.sum() for b in batches).float(),
        group).clamp_min(1.0)
    total = torch.zeros((), device=batches[0].x.device)
    for b in batches:
        out = model(b.x, b.graphs(), generator)
        s, _ = task_loss_sums(task, out, b.y, b.train_mask)
        part = s / count.to(s.dtype)
        part.backward()
        total = total + part.detach()
    all_reduce_grads(model.parameters(), group)
    opt.step()
    return all_reduce_sum(total, group)


def dist_gs_train_epoch_mb(model: torch.nn.Module,
                           opt: torch.optim.Optimizer,
                           batches: Sequence[SubgraphBatch],
                           generator: Optional[torch.Generator], task: str,
                           batch_size: int, num_shards: int,
                           group=None) -> torch.Tensor:
    """MB over the subgraph axis (``make_dist_gs_train_epoch_mb``): each
    rank cuts its slice of each bucket into chunks of ``ceil(batch_size /
    num_shards)`` subgraphs, and local chunk ``k`` of every rank is global
    chunk ``k``, one optimizer step with the gradients summed over the
    ranks.  The chunks' train counts are summed over the ranks once a
    bucket, before its first chunk, so every rank skips the chunks whose
    count is 0 alike (no step, Adam's state untouched).  Returns the sum
    of the stepped chunks' losses, each summed over the ranks."""
    bs_local = max(1, -(-batch_size // num_shards))
    total = torch.zeros((), device=batches[0].x.device)
    model.train()
    for b in batches:
        chunks, k = chunk_pad(b, bs_local)
        s = b.num_subgraphs
        per = b.train_mask.reshape(s, -1).sum(dim=1).float()
        per = torch.nn.functional.pad(per, (0, k * bs_local - s))
        counts = all_reduce_sum(per.reshape(k, bs_local).sum(dim=1),
                                group).tolist()
        for chunk, c in zip(chunks, counts):
            if c == 0:
                continue
            opt.zero_grad(set_to_none=True)
            out = model(chunk.x, chunk.graphs(), generator)
            ls, _ = task_loss_sums(task, out, chunk.y, chunk.train_mask)
            loss = ls / c
            loss.backward()
            all_reduce_grads(model.parameters(), group)
            opt.step()
            total = total + all_reduce_sum(loss, group)
    return total


def dist_gs_eval_step(model: torch.nn.Module,
                      batches: Sequence[SubgraphBatch], task: str,
                      split: str = "val", group=None) -> tuple:
    """(loss, metric) over every bucket's consuming ``split`` nodes on
    every rank (``make_dist_gs_eval_step_multi``): the five sums (loss,
    count, metric, y, y²) summed over the buckets, then over the ranks."""
    sums = [gs_eval_bucket_sums(model, b, task, split) for b in batches]
    ls, c, ms, ys, y2s = all_reduce_sum(torch.stack([
        sum(s[i] for s in sums).float().reshape(()) for i in range(5)]),
        group)
    return (ls / c.clamp_min(1.0),
            task_metric_from_sums(task, ls, c, ms, ys, y2s))
