"""Differentiable collectives of the distributed layers, in place of the
JAX package's ``jax.lax.all_to_all``, ``all_gather`` and ``psum``.

A rank's loss reaches other ranks' activations only through these
exchanges, so each forward collective has the collective that is its
transpose as its backward: the halo's all-to-all is its own transpose, and
an all-gather's is a reduce-scatter (sum).  Every rank must run the
backward, even one whose loss is zero, because the backward passes are
collectives too.  ``all_reduce_grads`` is the ``psum`` of the replicated
parameters' gradients.
"""

from __future__ import annotations

from typing import Iterable

import torch
import torch.distributed as dist

# the *_single names replace the *_tensor ones in newer PyTorch releases
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group``: block ``d`` of the leading axis
    goes to the group's rank ``d``, and block ``d`` of the output comes
    from it.  The backward is the same exchange of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


class _AllGather(torch.autograd.Function):
    """The group's ranks' ``x`` stacked along the leading axis in group
    order; the backward reduce-scatters (sums) the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        size = dist.get_world_size(group)
        out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        size = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // size,) + tuple(g.shape[1:]))
        _reduce_scatter(out, g.contiguous(), op=dist.ReduceOp.SUM,
                        group=ctx.group)
        return out, None


def halo_exchange(buf: torch.Tensor, mesh) -> torch.Tensor:
    """(D, K, F) rows to send to each chip of this host → the (D·K, F) halo
    table: rows ``[d·K, (d+1)·K)`` come from chip ``d``."""
    return _AllToAll.apply(buf, mesh.chip_group).reshape(-1, buf.shape[-1])


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """(n, F) rows of this rank → the (P·n, F) rows of every rank of
    ``group`` (None: the default group), rank ``p``'s at ``[p·n,
    (p+1)·n)``: ``jax.lax.all_gather(x, axis, tiled=True)``.  The backward
    reduce-scatters (sums) the cotangent."""
    return _AllGather.apply(x, group)


def gather_summaries(local: torch.Tensor, mesh) -> torch.Tensor:
    """(C, F) summaries of this shard → the (P·C, F) table of every shard,
    rows ``[p·C, (p+1)·C)`` from shard ``p = host·D + chip``: a gather over
    the chip group, then one over the host group, as the JAX package nests
    its two single-axis gathers."""
    return _AllGather.apply(_AllGather.apply(local, mesh.chip_group),
                            mesh.host_group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (a copy; no gradient)."""
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_grads(params: Iterable[torch.nn.Parameter],
                     group=None) -> None:
    """Sum every parameter's ``.grad`` over ``group`` in one all-reduce of
    a flat buffer (a missing gradient counts as zeros)."""
    params = list(params)
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1)
                      for p in params])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    i = 0
    for p in params:
        n = p.numel()
        p.grad = flat[i:i + n].view_as(p).clone()
        i += n
