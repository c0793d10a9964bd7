"""ctypes binding for the C++ blossom matching (``native/blossom.cpp``).

The library is compiled with g++ (the JAX package's flags) into
``build/fitgnn_tpu_torch/`` at first use.  A failed build raises; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from fitgnn_tpu_torch.utils.build import REPO_ROOT, Target, build

_SRC = os.path.join(REPO_ROOT, "native", "blossom.cpp")

BLOSSOM = Target("blossom", [_SRC], lambda out: [
    "g++", "-O2", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", out])

# the core stores the instance as a dense (2n)² table and refuses more nodes
# (``coarsen/matching.py`` runs ``coarsen/blossom.py`` above it)
MAX_NODES = 3000

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    build([BLOSSOM])
    lib = ctypes.CDLL(BLOSSOM.path)
    lib.max_weight_matching.restype = ctypes.c_int64
    lib.max_weight_matching.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64)]
    _lib_handle = lib
    return lib


def max_weight_matching_native(edges: np.ndarray, weights: np.ndarray,
                               num_nodes: int, max_cardinality: bool = False
                               ) -> np.ndarray:
    """mate array (n,), -1 = unmatched, for at most ``MAX_NODES`` nodes
    (``ValueError`` above: ``coarsen/blossom.py`` takes those).  Raises
    ``RuntimeError`` when the core fails."""
    if num_nodes > MAX_NODES:
        raise ValueError(f"the native blossom holds at most {MAX_NODES} "
                         f"nodes, got {num_nodes}")
    lib = _lib()
    eu = np.ascontiguousarray(edges[0], dtype=np.int64)
    ev = np.ascontiguousarray(edges[1], dtype=np.int64)
    ew = np.ascontiguousarray(weights, dtype=np.float64)
    mate = np.empty(num_nodes, dtype=np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    pairs = lib.max_weight_matching(
        num_nodes, len(eu), p64(eu), p64(ev),
        ew.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        int(max_cardinality), p64(mate))
    if pairs < 0:
        raise RuntimeError(f"native blossom failed on {num_nodes} nodes, "
                           f"{len(eu)} edges")
    return mate
