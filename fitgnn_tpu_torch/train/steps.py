"""Train and eval steps for node-level tasks, as the JAX package's
``train/steps.py`` computes them.

* Gc (and ``--baseline``): one full-batch step on one graph
  (``gc_train_step``, ``gc_eval_step``).
* the Gc phase as one loop that never reads a value back
  (``gc_train_epochs_fused``, the JAX package's ``gc_train_epochs_scan``).
* Gs: the model runs on every subgraph of a ``SubgraphBatch`` at once (the
  layers take the stack; the JAX package ``jax.vmap``s them), with the loss
  over all consuming train nodes: ``gs_train_step_gd`` takes one optimizer
  step from it, ``gs_train_epoch_mb`` one step per chunk of subgraphs,
  in order, skipping chunks without a train node; ``gs_eval_step`` gives
  the masked loss and metric over the consuming val or test nodes.
* Gs over size buckets (a tuple of batches): ``gs_train_step_gd_multi``
  takes one step from the masked mean over every bucket;
  ``gs_eval_bucket_sums`` gives one bucket's sums, in chunks of subgraphs
  if asked, which ``finish_eval_from_sums`` combines;
  ``gs_eval_step_multi`` does both at once.

Dropout draws from the ``torch.Generator`` the caller passes, so random
streams differ from JAX's.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch
from fitgnn_tpu_torch.train.losses import (masked_accuracy, masked_l1,
                                           masked_l1_std_normalized,
                                           masked_nll, task_loss_sums,
                                           task_metric_from_sums,
                                           task_metric_sums)


def adam_l2(params: Iterable[torch.nn.Parameter], lr: float,
            weight_decay: float) -> torch.optim.Adam:
    """optax's ``add_decayed_weights(wd)`` → ``adam(lr)``: the L2 term
    enters the gradient of every parameter, biases included, before the
    moments (not AdamW), with eps 1e-8 outside the square root."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def _loss(task: str, out, y, mask, reduction: str = "mean"):
    if task == "classification":
        return masked_nll(out, y, mask, reduction)
    return masked_l1(out, y, mask, reduction)


def gc_train_step(model: nn.Module, opt: torch.optim.Optimizer, g: Graph,
                  y: torch.Tensor, mask: torch.Tensor,
                  generator: Optional[torch.Generator], task: str,
                  reduction: str = "mean") -> torch.Tensor:
    """One full-batch step in train mode: forward with dropout drawn from
    ``generator``, masked loss, backward, optimizer update.  Returns the
    loss (detached; the parameters' ``.grad`` keep this step's
    gradients)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    loss = _loss(task, model(g.x, g, generator), y, mask, reduction)
    loss.backward()
    opt.step()
    return loss.detach()


def gc_eval_step(model: nn.Module, g: Graph, y: torch.Tensor,
                 mask: torch.Tensor, task: str):
    """Eval-mode forward: (mean masked loss, accuracy) for classification,
    (mean masked L1, std-normalized L1) for regression."""
    model.eval()
    with torch.no_grad():
        out = model(g.x, g)
        return _loss(task, out, y, mask), _metric(task, out, y, mask)


def gc_train_epochs_fused(model: nn.Module, opt: torch.optim.Optimizer,
                          g: Graph, y_train: torch.Tensor,
                          train_mask: torch.Tensor, y_val: torch.Tensor,
                          val_mask: torch.Tensor,
                          generator: Optional[torch.Generator],
                          n_epochs: int, task: str, reduction: str = "mean",
                          best_state: Optional[dict] = None,
                          best_val: float = float("inf")):
    """``n_epochs`` of ``gc_train_step`` and the val loss of
    ``gc_eval_step``, dropout drawn from ``generator`` in the order of the
    per-epoch loop, without reading a value back: the best val loss and a
    copy of the parameters it was reached with stay on the device, taken
    where ``val < best_val`` (from ``best_val``, inf for a fresh phase, as
    the JAX package's ``gc_train_epochs_scan`` starts), and each epoch's
    train and val loss is written into a device tensor.

    Returns ``(best_state, best_val, train_losses, val_losses)``, all on
    the device: the caller reads them once the phase is over."""
    params = model.state_dict()
    if best_state is None:
        best_state = params
    best = {k: v.detach().clone() for k, v in best_state.items()}
    dev = g.x.device
    best_v = torch.full((), best_val, dtype=torch.float32, device=dev)
    train_losses = torch.empty(n_epochs, dtype=torch.float32, device=dev)
    val_losses = torch.empty(n_epochs, dtype=torch.float32, device=dev)
    for epoch in range(n_epochs):
        train_losses[epoch] = gc_train_step(model, opt, g, y_train,
                                            train_mask, generator, task,
                                            reduction)
        val, _ = gc_eval_step(model, g, y_val, val_mask, task)
        val_losses[epoch] = val
        improved = val < best_v
        best_v = torch.where(improved, val, best_v)
        for k, v in params.items():
            best[k].copy_(torch.where(improved, v, best[k]))
    return best, best_v, train_losses, val_losses


def _metric(task: str, out, y, mask):
    if task == "classification":
        return masked_accuracy(out, y, mask)
    # the loss stays plain masked L1 (best-val selection), the metric is
    # the std-normalized L1
    return masked_l1_std_normalized(out, y, mask)


def gs_train_step_gd(model: nn.Module, opt: torch.optim.Optimizer,
                     batch: SubgraphBatch,
                     generator: Optional[torch.Generator], task: str,
                     reduction: str = "mean") -> torch.Tensor:
    """Accumulate-all-then-step: one update from the masked loss over every
    subgraph's train nodes (the masks are consume-filtered)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    out = model(batch.x, batch.graphs(), generator)
    loss = _loss(task, out, batch.y, batch.train_mask, reduction)
    loss.backward()
    opt.step()
    return loss.detach()


def pad_subgraphs(batch: SubgraphBatch, pad: int) -> SubgraphBatch:
    """``batch`` with ``pad`` empty subgraphs after its own (zero features
    and weights, no nodes or edges, all masks False), which contribute
    nothing."""
    if not pad:
        return batch
    return SubgraphBatch(*(
        None if a is None
        else torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        for a in batch))


def chunk_pad(batch: SubgraphBatch, chunk: int) -> tuple:
    """The batch cut into ``k`` chunks of ``chunk`` subgraphs, in order:
    views, except the last, which is padded with empty subgraphs
    (``pad_subgraphs``).  Returns ``(chunks, k)``."""
    size = batch.num_subgraphs
    k = -(-size // chunk)
    chunks = [batch.slice(i * chunk, (i + 1) * chunk) for i in range(k)]
    chunks[-1] = pad_subgraphs(chunks[-1], k * chunk - size)
    return chunks, k


def gs_train_epoch_mb(model: nn.Module, opt: torch.optim.Optimizer,
                      batch: SubgraphBatch,
                      generator: Optional[torch.Generator], task: str,
                      batch_size: int = 1,
                      reduction: str = "mean") -> torch.Tensor:
    """Minibatch mode: one optimizer step per chunk of ``batch_size``
    subgraphs, chunks in order.  A chunk without a train node leaves the
    parameters and the optimizer state untouched (which chunks hold one is
    read once, before the first).  Returns the sum of the stepped chunks'
    losses."""
    chunks, _ = chunk_pad(batch, batch_size)
    s = batch.num_subgraphs
    has = batch.train_mask.reshape(s, -1).any(dim=1)
    has = torch.nn.functional.pad(has, (0, len(chunks) * batch_size - s))
    has = has.reshape(len(chunks), batch_size).any(dim=1).tolist()
    total = torch.zeros((), device=batch.x.device)
    for chunk, stepped in zip(chunks, has):
        if stepped:
            total = total + gs_train_step_gd(model, opt, chunk, generator,
                                             task, reduction)
    return total


def gs_eval_step(model: nn.Module, batch: SubgraphBatch, task: str,
                 split: str = "val"):
    """Eval-mode forward of every subgraph: the masked loss and metric over
    the consuming ``split`` ("val" or "test") nodes."""
    mask = batch.val_mask if split == "val" else batch.test_mask
    model.eval()
    with torch.no_grad():
        out = model(batch.x, batch.graphs())
        return _loss(task, out, batch.y, mask), _metric(task, out, batch.y,
                                                        mask)


def gs_train_step_gd_multi(model: nn.Module, opt: torch.optim.Optimizer,
                           batches, generator: Optional[torch.Generator],
                           task: str) -> torch.Tensor:
    """GD over size-bucketed batches: one update from Σ loss / Σ count over
    every bucket's train nodes, the masked mean whatever the loss reduction
    (as the JAX package's ``gs_train_step_gd_multi``, which takes none).
    The backward runs bucket by bucket on ``Σ_b loss / count`` (the count
    does not depend on the parameters), so one bucket's activations are
    alive at a time.  Returns the loss."""
    model.train()
    opt.zero_grad(set_to_none=True)
    count = sum(b.train_mask.sum() for b in batches).clamp_min(1)
    total = torch.zeros((), device=batches[0].x.device)
    for b in batches:
        out = model(b.x, b.graphs(), generator)
        s, _ = task_loss_sums(task, out, b.y, b.train_mask)
        part = s / count.to(s.dtype)
        part.backward()
        total = total + part.detach()
    opt.step()
    return total


def gs_eval_bucket_sums(model: nn.Module, b: SubgraphBatch, task: str,
                        split: str = "val", chunk: int = 0) -> tuple:
    """One bucket's ``(loss_sum, count, metric_sum, y_sum, y2_sum)`` over
    its consuming ``split`` nodes, eval mode.  ``chunk > 0`` runs the model
    on slices of ``chunk`` subgraphs in turn, so the activations of one
    slice are alive at a time."""
    model.eval()
    size = b.num_subgraphs
    step = chunk if chunk and size > chunk else size
    sums = None
    with torch.no_grad():
        for start in range(0, size, step):
            bi = b.slice(start, start + step)
            mask = bi.val_mask if split == "val" else bi.test_mask
            out = model(bi.x, bi.graphs())
            part = (*task_loss_sums(task, out, bi.y, mask),
                    *task_metric_sums(task, out, bi.y, mask))
            sums = part if sums is None else tuple(
                a + p for a, p in zip(sums, part))
    return sums


def finish_eval_from_sums(task: str, sums) -> tuple:
    """(loss, metric) as floats from the buckets' ``gs_eval_bucket_sums``,
    added on the host in float64."""
    ls, c, ms, ys, y2s = (
        torch.tensor(sum(float(s[i]) for s in sums), dtype=torch.float64)
        for i in range(5))
    metric = task_metric_from_sums(task, ls, c, ms, ys, y2s)
    return float(ls / c.clamp_min(1.0)), float(metric)


def gs_eval_step_multi(model: nn.Module, batches, task: str,
                       split: str = "val", chunk=0):
    """The masked loss and metric over every bucket's consuming ``split``
    nodes, on the device.  ``chunk``: as ``gs_eval_bucket_sums``, one int
    for every bucket or a tuple with one a bucket."""
    chunks = chunk if isinstance(chunk, tuple) else (chunk,) * len(batches)
    sums = [gs_eval_bucket_sums(model, b, task, split, ck)
            for b, ck in zip(batches, chunks)]
    ls, c, ms, ys, y2s = (sum(s[i] for s in sums) for i in range(5))
    return ls / c.clamp_min(1.0), task_metric_from_sums(task, ls, c, ms, ys,
                                                        y2s)
