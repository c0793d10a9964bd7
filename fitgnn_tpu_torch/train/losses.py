"""Masked losses and metrics over the padded node rows, as the JAX
package's ``train/losses.py`` computes them.  Regression metrics are
normalized by the std of the masked labels."""

from __future__ import annotations

import torch


def masked_nll(log_probs: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    """Negative log-likelihood over masked rows ('mean' or 'sum').
    ``log_probs``: (N, C); ``labels``: (N,) int; ``mask``: (N,) bool.
    Unmasked rows are selected out with ``where``, not multiplied by 0, so
    a ``-inf`` there cannot make a NaN."""
    picked = log_probs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    total = torch.where(mask, -picked, 0.0).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp_min(1).to(total.dtype)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
              reduction: str = "mean") -> torch.Tensor:
    """Absolute error over masked rows (``pred`` reshaped to ``target``)."""
    pred = pred.reshape(target.shape)
    total = torch.where(mask, (pred - target).abs(), 0.0).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp_min(1).to(total.dtype)


def masked_l1_std_normalized(pred: torch.Tensor, target: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """L1 / std(target over mask): the regression metric."""
    l1 = masked_l1(pred, target, mask)
    m = mask.to(pred.dtype)
    count = m.sum().clamp_min(1.0)
    mean = (target * m).sum() / count
    var = (((target - mean) ** 2) * m).sum() / count
    return l1 / var.sqrt().clamp_min(1e-12)


def masked_accuracy(log_probs: torch.Tensor, labels: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    correct = ((log_probs.argmax(dim=-1) == labels).float() * m).sum()
    return correct / m.sum().clamp_min(1.0)
