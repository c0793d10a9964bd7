"""ctypes binding for the C++ graph ingest core (``native/graphbuild.cpp``).

``build_graph`` takes this branch for unweighted inputs of more than
``NATIVE_EDGE_THRESHOLD`` edges, as the JAX package does.  The core returns
the edges sorted by receiver then sender, which is not the numpy branch's
order (a stable sort on the receiver alone), so the threshold is what keeps
both packages' edge orders equal.  The library is compiled with g++ (the
JAX package's flags, so the weights come out bit for bit on one host) into
``build/fitgnn_tpu_torch/`` at first use; a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Tuple

import numpy as np

from fitgnn_tpu_torch.utils.build import REPO_ROOT, Target, build

_SRC = os.path.join(REPO_ROOT, "native", "graphbuild.cpp")

NATIVE_EDGE_THRESHOLD = 2_000_000

GRAPHBUILD = Target("graphbuild", [_SRC], lambda out: [
    "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    _SRC, "-o", out])

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    build([GRAPHBUILD])
    lib = ctypes.CDLL(GRAPHBUILD.path)
    lib.build_graph_edges.restype = ctypes.c_int64
    lib.build_graph_edges.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    _lib_handle = lib
    return lib


def _ptr_i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def build_edges_native(
    senders: np.ndarray, receivers: np.ndarray, num_nodes: int,
    undirected: bool = True, self_loops: bool = True, normalize: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (senders, receivers, weights) sorted by receiver then sender,
    deduplicated, optionally symmetrized/self-looped/GCN-normalized."""
    s = np.ascontiguousarray(senders, dtype=np.int64)
    r = np.ascontiguousarray(receivers, dtype=np.int64)
    m = len(s)
    cap = max((2 * m if undirected else m) + (num_nodes if self_loops else 0),
              1)
    out_s = np.empty(cap, dtype=np.int64)
    out_r = np.empty(cap, dtype=np.int64)
    out_w = np.empty(cap, dtype=np.float32)
    n_out = _lib().build_graph_edges(
        num_nodes, m, _ptr_i64(s), _ptr_i64(r),
        int(undirected), int(self_loops), int(normalize),
        _ptr_i64(out_s), _ptr_i64(out_r),
        out_w.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap)
    if n_out < 0:
        raise RuntimeError("build_graph_edges failed (bad input or cap)")
    return out_s[:n_out], out_r[:n_out], out_w[:n_out]
