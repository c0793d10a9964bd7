"""Row gather and segment reductions for edge→node aggregation (int64
indices), as the JAX package's ``ops/segment.py`` computes them."""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` along rows."""
    return a.index_select(0, idx.long())


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``out[s] = Σ_{i: ids[i]=s} data[i]``; empty segments are 0."""
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def _per_row(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``v`` (leading dim only) shaped to broadcast against ``like``."""
    return v.reshape(v.shape + (1,) * (like.dim() - v.dim()))


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over each segment; ``mask`` excludes padding rows from the
    count.  Empty segments are 0."""
    if mask is not None:
        m = mask.to(data.dtype)
        data = data * _per_row(m, data)
    else:
        m = torch.ones(segment_ids.shape[0], dtype=data.dtype,
                       device=data.device)
    counts = segment_sum(m, segment_ids, num_segments).clamp_min(1.0)
    return segment_sum(data, segment_ids, num_segments) / _per_row(
        counts, data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max over each segment; empty (or fully masked) segments are 0."""
    if mask is not None:
        data = torch.where(_per_row(mask, data), data, _NEG)
    out = torch.full((num_segments,) + tuple(data.shape[1:]), _NEG,
                     dtype=data.dtype, device=data.device)
    idx = _per_row(segment_ids.long(), data).expand_as(data)
    out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
    return torch.where(out <= _NEG / 2, 0.0, out)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Max-subtracted softmax over each segment (GAT attention).

    ``logits``: (E,) or (E, H).  Masked entries get 0; a segment without
    unmasked entries divides by the 1e-16 clamp.  The per-segment max is
    a constant shift (softmax is shift-invariant), so it is detached: the
    gradient is the same as the JAX package's, which differentiates
    through a max whose contributions cancel."""
    if mask is not None:
        logits = torch.where(_per_row(mask, logits), logits, _NEG)
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    ex = torch.exp(logits - take_rows(seg_max, segment_ids))
    if mask is not None:
        ex = torch.where(_per_row(mask, ex), ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments).clamp_min(1e-16)
    return ex / take_rows(denom, segment_ids)
