"""Community detection (first-party C++ Leiden) + community utilities.

The C++ core is the repository's shared ``native/leiden.cpp``.  It is
compiled with g++ (the JAX package's flags) into the port's own build
directory and bound through ctypes.  On top of the raw partition:

* ``merge_communities``  — greedily keep the largest communities until the
  node cap is reached (the 165k-node proxy for ogbn-products);
* ``community_order``    — node permutation grouping communities
  contiguously;
* ``hierarchical_community_order`` — the tile-aligned two-level order that
  makes the adjacency block-dense for the hybrid operator.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from fitgnn_tpu_torch.utils.build import REPO_ROOT, Target, build

_SRC = os.path.join(REPO_ROOT, "native", "leiden.cpp")

LEIDEN = Target("leiden", [_SRC], lambda out: [
    "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    _SRC, "-o", out])

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    build([LEIDEN])
    lib = ctypes.CDLL(LEIDEN.path)
    lib.leiden_partition.restype = ctypes.c_int64
    lib.leiden_partition.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_uint64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int64)]
    lib.modularity.restype = ctypes.c_double
    lib.modularity.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_double]
    _lib_handle = lib
    return lib


def _as_i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def leiden_communities(senders: np.ndarray, receivers: np.ndarray,
                       num_nodes: int, weight: Optional[np.ndarray] = None,
                       resolution: float = 1.0, seed: int = 0,
                       max_levels: int = 20) -> np.ndarray:
    """Run Leiden; returns (num_nodes,) community labels 0..k-1."""
    s = np.ascontiguousarray(senders, dtype=np.int64)
    r = np.ascontiguousarray(receivers, dtype=np.int64)
    w_ptr = None
    if weight is not None:
        w = np.ascontiguousarray(weight, dtype=np.float64)
        w_ptr = w.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    out = np.empty(num_nodes, dtype=np.int64)
    k = _lib().leiden_partition(
        num_nodes, len(s), _as_i64_ptr(s), _as_i64_ptr(r), w_ptr,
        float(resolution), int(seed), int(max_levels), _as_i64_ptr(out))
    if k < 0:
        raise RuntimeError("leiden_partition failed")
    return out


def partition_modularity(senders: np.ndarray, receivers: np.ndarray,
                         num_nodes: int, labels: np.ndarray,
                         weight: Optional[np.ndarray] = None,
                         resolution: float = 1.0) -> float:
    """The modularity of the partition ``labels`` (at ``resolution``) on
    the graph of the edges ``senders`` → ``receivers`` (``weight``, or 1
    each): the ``modularity`` entry of the Leiden library built from
    ``native/leiden.cpp``, as the JAX package's ``partition_modularity``
    reads it."""
    s = np.ascontiguousarray(senders, dtype=np.int64)
    r = np.ascontiguousarray(receivers, dtype=np.int64)
    lab = np.ascontiguousarray(labels, dtype=np.int64)
    w_ptr = None
    if weight is not None:
        w = np.ascontiguousarray(weight, dtype=np.float64)
        w_ptr = w.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    return float(_lib().modularity(
        num_nodes, len(s), _as_i64_ptr(s), _as_i64_ptr(r), w_ptr,
        _as_i64_ptr(lab), float(resolution)))


def merge_communities(labels: np.ndarray, cap: int) -> np.ndarray:
    """Greedily keep the largest communities whose cumulative size stays
    ≤ cap; returns the selected node indices."""
    comms, counts = np.unique(labels, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    keep = []
    total = 0
    for c in order:
        if total + counts[c] <= cap:
            keep.append(comms[c])
            total += counts[c]
            if total == cap:
                break
    keep_set = np.isin(labels, np.asarray(keep))
    return np.where(keep_set)[0]


def community_order(labels: np.ndarray) -> np.ndarray:
    """Permutation placing each community's nodes contiguously (larger
    communities first)."""
    comms, counts = np.unique(labels, return_counts=True)
    rank = {c: i for i, c in enumerate(comms[np.argsort(-counts,
                                                        kind="stable")])}
    key = np.array([rank[c] for c in labels], dtype=np.int64)
    return np.argsort(key, kind="stable")


def hierarchical_community_order(senders: np.ndarray, receivers: np.ndarray,
                                 num_nodes: int, seed: int = 0,
                                 sub_resolution: float = 1.0,
                                 block: int = 128) -> np.ndarray:
    """Tile-aligned two-level ordering for dense BCSR tiles.

    1. Outer Leiden (modularity) finds communities; any community larger
       than ``block`` is re-clustered on its slice-local edges and
       still-oversized sub-groups are chopped into ``block``-sized pieces.
    2. The ≤``block``-node groups are bin-packed into ``block``-node bins
       (best-fit decreasing, within each outer community); exactly-full
       bins are emitted first so their tiles stay aligned.

    Returns the node permutation.
    """
    labels = leiden_communities(senders, receivers, num_nodes, seed=seed)
    order = community_order(labels)
    inv = np.empty(num_nodes, dtype=np.int64)
    inv[order] = np.arange(num_nodes)
    s2, r2 = inv[senders], inv[receivers]
    lab2 = labels[order]

    # --- refine to ≤block-node groups (slice-local edges via one sort) ----
    group = np.empty(num_nodes, dtype=np.int64)
    next_group = 0
    comms, starts = np.unique(lab2, return_index=True)
    bounds = np.sort(np.append(starts, num_nodes))
    eorder = np.argsort(r2, kind="stable")
    r2s, s2s = r2[eorder], s2[eorder]
    for b0, b1 in zip(bounds[:-1], bounds[1:]):
        size = b1 - b0
        if size <= block:
            group[b0:b1] = next_group
            next_group += 1
            continue
        lo, hi = np.searchsorted(r2s, [b0, b1])
        seg_s, seg_r = s2s[lo:hi], r2s[lo:hi]
        keep = (seg_s >= b0) & (seg_s < b1)
        if keep.any():
            sub_lab = leiden_communities(seg_s[keep] - b0, seg_r[keep] - b0,
                                         size, resolution=sub_resolution,
                                         seed=seed)
        else:
            sub_lab = np.zeros(size, dtype=np.int64)
        sub_ord = community_order(sub_lab)
        sl = sub_lab[sub_ord]
        run_break = np.nonzero(np.diff(sl))[0] + 1
        pieces = np.split(np.arange(size), run_break)
        gl = np.empty(size, dtype=np.int64)
        for piece in pieces:
            for off in range(0, len(piece), block):
                gl[piece[off:off + block]] = next_group
                next_group += 1
        group[b0:b1][sub_ord] = gl

    # --- bin-pack groups into block-sized bins, per outer community -----
    sizes = np.bincount(group, minlength=next_group)
    group_comm = np.empty(next_group, dtype=np.int64)
    for b0, b1 in zip(bounds[:-1], bounds[1:]):   # slice → community id
        group_comm[group[b0:b1]] = b0
    full_seq, tail_seq = [], []
    for c in np.unique(group_comm):
        gids = np.nonzero(group_comm == c)[0]
        gids = gids[np.argsort(-sizes[gids], kind="stable")]
        by_free = {}                       # free space -> [bin index]
        bin_groups, bin_free = [], []
        for gid in gids:
            sz = int(sizes[gid])
            if sz == 0:
                continue
            bi = None
            for free in range(sz, block + 1):  # best fit within community
                if by_free.get(free):
                    bi = by_free[free].pop()
                    break
            if bi is None:
                bi = len(bin_groups)
                bin_groups.append([])
                bin_free.append(block)
            bin_groups[bi].append(gid)
            bin_free[bi] -= sz
            by_free.setdefault(bin_free[bi], []).append(bi)
        for bi, gl in enumerate(bin_groups):
            (full_seq if bin_free[bi] == 0 else tail_seq).extend(gl)

    rank = np.empty(next_group, dtype=np.int64)
    for pos, gid in enumerate(full_seq + tail_seq):
        rank[gid] = pos
    return order[np.argsort(rank[group], kind="stable")]
