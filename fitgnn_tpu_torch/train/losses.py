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


# sum forms: the pieces of a masked mean that add across size buckets and
# eval chunks, finished once over every piece


def masked_nll_sum(log_probs: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> tuple:
    """(Σ masked NLL, masked count)."""
    picked = log_probs.gather(-1, labels.long().unsqueeze(-1)).squeeze(-1)
    return (torch.where(mask, -picked, 0.0).sum(),
            mask.sum().to(log_probs.dtype))


def masked_l1_sum(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor) -> tuple:
    """(Σ masked absolute error, masked count)."""
    pred = pred.reshape(target.shape)
    return (torch.where(mask, (pred - target).abs(), 0.0).sum(),
            mask.sum().to(pred.dtype))


def masked_correct_sum(log_probs: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor) -> tuple:
    """(masked count of right argmaxes, masked count)."""
    m = mask.float()
    return ((log_probs.argmax(dim=-1) == labels).float() * m).sum(), m.sum()


def task_loss_sums(task: str, out, y, mask) -> tuple:
    """(Σ masked loss, masked count): NLL for classification, L1 for
    regression."""
    if task == "classification":
        return masked_nll_sum(out, y, mask)
    return masked_l1_sum(out, y, mask)


def task_metric_sums(task: str, out, y, mask) -> tuple:
    """The metric's pieces ``(metric_sum, y_sum, y2_sum)``: the right
    argmaxes for classification (y moments zero); for regression the masked
    target moments Σy and Σy², since the std-normalized L1 needs the std of
    every piece's targets together, not one piece's."""
    zero = out.new_zeros(())
    if task == "classification":
        return masked_correct_sum(out, y, mask)[0], zero, zero
    m = mask.to(out.dtype)
    return zero, (y * m).sum(), ((y ** 2) * m).sum()


def task_metric_from_sums(task: str, loss_sum, count, metric_sum, y_sum,
                          y2_sum) -> torch.Tensor:
    """The metric from the summed pieces (tensors): accuracy, or the L1
    over the std of the masked targets."""
    count = count.clamp_min(1.0)
    if task == "classification":
        return metric_sum / count
    mean = y_sum / count
    std = (y2_sum / count - mean ** 2).clamp_min(0.0).sqrt()
    return (loss_sum / count) / std.clamp_min(1e-12)
