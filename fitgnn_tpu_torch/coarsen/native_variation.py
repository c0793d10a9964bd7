"""ctypes binding for the C++ local-variation coarsening core
(``native/variation.cpp``).

The library is compiled with g++ (the JAX package's flags) into
``build/fitgnn_tpu_torch/`` at first use.  A failed build raises: the JAX
package falls back to the Python loop, which at the bench graph's size
would turn a coarsening of tens of seconds into a much longer one.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from fitgnn_tpu_torch.coarsen.lapgraph import LapGraph
from fitgnn_tpu_torch.utils.build import REPO_ROOT, Target, build

_SRC = os.path.join(REPO_ROOT, "native", "variation.cpp")

VARIATION = Target("variation", [_SRC], lambda out: [
    "g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
    _SRC, "-o", out])

_lib_handle = None


def _lib() -> ctypes.CDLL:
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    build([VARIATION])
    lib = ctypes.CDLL(VARIATION.path)
    lib.variation_neighborhoods.restype = ctypes.c_int64
    lib.variation_neighborhoods.argtypes = [
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ctypes.c_double, ctypes.POINTER(ctypes.c_int64)]
    _lib_handle = lib
    return lib


def variation_neighborhoods_native(g: LapGraph, A: np.ndarray,
                                   r: float) -> np.ndarray:
    """One level of neighborhood local-variation coarsening in C++.
    Returns the parent map (n,); raises when the core fails."""
    lib = _lib()
    W = g.W.tocsr()
    W.sort_indices()
    indptr = np.ascontiguousarray(W.indptr, dtype=np.int64)
    indices = np.ascontiguousarray(W.indices, dtype=np.int64)
    wvals = np.ascontiguousarray(W.data, dtype=np.float64)
    deg = np.ascontiguousarray(g.dw, dtype=np.float64)
    A = np.ascontiguousarray(A, dtype=np.float64)
    out = np.empty(g.N, dtype=np.int64)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def pd(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    k = lib.variation_neighborhoods(
        g.N, p64(indptr), p64(indices), pd(wvals), pd(deg), pd(A),
        A.shape[1], float(r), p64(out))
    if k < 0:
        raise RuntimeError(f"native variation core failed on {g.N} nodes "
                           f"(K={A.shape[1]})")
    return out
