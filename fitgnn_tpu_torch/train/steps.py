"""Train and eval steps for node-level tasks, as the JAX package's
``train/steps.py`` computes them.

* Gc (and ``--baseline``): one full-batch step on one graph
  (``gc_train_step``, ``gc_eval_step``).
* Gs: the model runs on every subgraph of a ``SubgraphBatch`` at once (the
  layers take the stack; the JAX package ``jax.vmap``s them), with the loss
  over all consuming train nodes: ``gs_train_step_gd`` takes one optimizer
  step from it, ``gs_train_epoch_mb`` one step per chunk of subgraphs,
  in order, skipping chunks without a train node; ``gs_eval_step`` gives
  the masked loss and metric over the consuming val or test nodes.

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
                                           masked_nll)


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


def chunk_pad(batch: SubgraphBatch, chunk: int) -> tuple:
    """The batch cut into ``k`` chunks of ``chunk`` subgraphs, in order:
    views, except the last, which is padded with empty subgraphs (zero
    features and weights, no nodes or edges, all masks False), so they
    contribute nothing.  Returns ``(chunks, k)``."""
    size = batch.num_subgraphs
    k = -(-size // chunk)
    chunks = [batch.slice(i * chunk, (i + 1) * chunk) for i in range(k)]
    pad = k * chunk - size
    if pad:
        def p(a):
            if a is None:
                return None
            return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

        chunks[-1] = SubgraphBatch(*(p(v) for v in chunks[-1]))
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
