"""Full-batch train and eval steps for node-level tasks, as the JAX
package's ``gc_train_step`` / ``gc_eval_step`` compute them."""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from fitgnn_tpu_torch.graph.container import Graph
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
        loss = _loss(task, out, y, mask)
        if task == "classification":
            return loss, masked_accuracy(out, y, mask)
        return loss, masked_l1_std_normalized(out, y, mask)
