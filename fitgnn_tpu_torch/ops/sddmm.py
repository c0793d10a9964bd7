"""Per-edge scores from node features and per-node projections (SDDMM,
the sampled dense-dense product), plain PyTorch as the JAX package's
``ops/sddmm.py`` is XLA."""

from __future__ import annotations

import torch

from fitgnn_tpu_torch.ops.segment import take_rows


def sddmm_dot(senders: torch.Tensor, receivers: torch.Tensor,
              a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``score[e] = ⟨a[send[e]], b[recv[e]]⟩`` for (N, F) features, (E,);
    (E, H) for (N, H, F)."""
    return (take_rows(a, senders) * take_rows(b, receivers)).sum(-1)


def gather_concat_score(senders: torch.Tensor, receivers: torch.Tensor,
                        src_score: torch.Tensor,
                        dst_score: torch.Tensor) -> torch.Tensor:
    """GAT's additive score ``s[e] = src_score[send[e]] + dst_score[recv[e]]``
    for (N,) or (N, H) scores; returns (E,) or (E, H)."""
    return take_rows(src_score, senders) + take_rows(dst_score, receivers)
