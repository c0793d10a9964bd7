"""Boundary-only halo exchange for the flat data mesh, as the JAX
package's ``parallel/halo.py``.

The all-gather layers move every shard's activations (N_global·F values a
layer).  With community placement only a small boundary crosses shards,
so this module moves exactly those rows:

* host side (``build_halo_plan``, numpy): for each ordered shard pair
  (p → q) the p-local rows that q's edges reference, padded to the largest
  pair's count K; each edge's sender remapped to an index into
  ``concat([local rows, received halo rows])``;
* device side (``halo_exchange``): one differentiable all-to-all of a
  (P, K, F) send buffer over the flat group, so a rank receives P·K·F
  values a layer instead of N_global·F.

Not to be confused with ``collectives.halo_exchange``, the hierarchical
layer's exchange over a host's chip group.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fitgnn_tpu_torch.ops.segment import take_rows
from fitgnn_tpu_torch.parallel.collectives import _AllToAll


class LocalHaloPlan(NamedTuple):
    """One rank's slices of a ``HaloPlan`` on its device: its edges with
    the senders pointing into ``concat([local rows, halo rows])``, and
    the rows it sends to each shard."""

    senders: torch.Tensor       # (E_loc,) the plan's senders_ext
    receivers: torch.Tensor     # (E_loc,) local row ids
    edge_weight: torch.Tensor   # (E_loc,)
    send_idx: torch.Tensor      # (P, K) local rows sent to each shard
    send_mask: torch.Tensor     # (P, K) bool


class HaloPlan(NamedTuple):
    """Static exchange plan, every shard's tables with the shard axis in
    front (numpy).  P = shards, K = padded per-pair row count."""

    send_idx: np.ndarray       # (P, P, K) local row ids shard p sends to q
                               #   (padded with 0; masked by send_mask)
    send_mask: np.ndarray      # (P, P, K) bool
    # per-shard edge tables with senders remapped into [0, n_loc + P*K):
    senders_ext: np.ndarray    # (P, E_loc) index into concat(local, halo)
    receivers: np.ndarray      # (P, E_loc) local
    edge_weight: np.ndarray    # (P, E_loc)

    @property
    def k(self) -> int:
        return self.send_idx.shape[-1]

    def local(self, p: int, device) -> LocalHaloPlan:
        """Shard ``p``'s slices on ``device``, indices as int64."""
        def t(a):
            a = np.ascontiguousarray(a[p])
            if a.dtype.kind in "iu":
                a = a.astype(np.int64)
            return torch.from_numpy(a).to(device)
        return LocalHaloPlan(t(self.senders_ext), t(self.receivers),
                             t(self.edge_weight), t(self.send_idx),
                             t(self.send_mask))


def build_halo_plan(senders_global: np.ndarray, receivers_local: np.ndarray,
                    edge_weight: np.ndarray, num_shards: int,
                    nodes_per_shard: int, pad_to: int = 8) -> HaloPlan:
    """From a ``ShardedGraph`` layout (per-shard edges with GLOBAL senders,
    LOCAL receivers) build the exchange plan."""
    P, E = senders_global.shape
    n_loc = nodes_per_shard
    s = np.asarray(senders_global, dtype=np.int64)

    # unique remote rows each shard q needs from each owner p
    need = [[None] * P for _ in range(P)]   # need[q][p] = local rows of p
    for q in range(P):
        owner = s[q] // n_loc
        for p in range(P):
            if p == q:
                continue
            need[q][p] = np.unique(s[q][owner == p]) % n_loc
    k = max((len(need[q][p]) for q in range(P) for p in range(P)
             if p != q), default=1)
    k = max(((k + pad_to - 1) // pad_to) * pad_to, pad_to)

    send_idx = np.zeros((P, P, k), dtype=np.int32)
    send_mask = np.zeros((P, P, k), dtype=bool)
    for p in range(P):
        for q in range(P):
            if p == q:
                continue
            rows = need[q][p]
            send_idx[p, q, : len(rows)] = rows
            send_mask[p, q, : len(rows)] = True

    # remap each shard's senders: local stay [0, n_loc); remote become
    # n_loc + p*k + position_in_need[q][p]
    senders_ext = np.zeros((P, E), dtype=np.int32)
    for q in range(P):
        owner = s[q] // n_loc
        local_pos = s[q] % n_loc
        ext = local_pos.copy()
        for p in range(P):
            if p == q:
                continue
            sel = owner == p
            if not sel.any():
                continue
            pos = np.searchsorted(need[q][p], local_pos[sel])
            ext[sel] = n_loc + p * k + pos
        senders_ext[q] = ext

    return HaloPlan(send_idx=send_idx, send_mask=send_mask,
                    senders_ext=senders_ext,
                    receivers=np.asarray(receivers_local, dtype=np.int32),
                    edge_weight=np.asarray(edge_weight))


def halo_exchange(h_local: torch.Tensor, send_idx: torch.Tensor,
                  send_mask: torch.Tensor, group=None) -> torch.Tensor:
    """The (P·K, F) halo table of this rank's remote rows: row p·K + j is
    row j that this rank received FROM shard p (zero where the sender's
    mask is False; no remapped sender points at a padding slot).

    ``send_idx`` / ``send_mask``: this rank's (P, K) slices.  One
    ``all_to_all_single`` over ``group`` (None: the default group), split
    on the destination axis; its backward is the same exchange."""
    f = h_local.shape[-1]
    buf = (take_rows(h_local, send_idx.reshape(-1)).reshape(
        send_idx.shape + (f,)) * send_mask[..., None].to(h_local.dtype))
    return _AllToAll.apply(buf, group).reshape(-1, f)
