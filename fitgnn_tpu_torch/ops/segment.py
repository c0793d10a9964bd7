"""Row gather and segment sum for edge→node aggregation (int64 indices)."""

from __future__ import annotations

import torch


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` along rows."""
    return a.index_select(0, idx.long())


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]=s} data[i]``; empty segments are 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)
