"""Per-edge GAT scores from per-node projections, plain PyTorch."""

from __future__ import annotations

import torch

from fitgnn_tpu_torch.ops.segment import take_rows


def gather_concat_score(senders: torch.Tensor, receivers: torch.Tensor,
                        src_score: torch.Tensor,
                        dst_score: torch.Tensor) -> torch.Tensor:
    """GAT's additive score ``s[e] = src_score[send[e]] + dst_score[recv[e]]``
    for (N,) or (N, H) scores; returns (E,) or (E, H)."""
    return take_rows(src_score, senders) + take_rows(dst_score, receivers)
