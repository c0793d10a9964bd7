"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), in ``build/fitgnn_tpu_torch/``, at first use.  Libraries
load with ``ctypes``; the calling module declares each function's
argument types.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from fitgnn_tpu_torch.utils.build import Target, build

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_fns: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the port's CUDA kernels build with it")
    return found


def _target(name: str, headers: tuple = ()) -> Target:
    src = os.path.join(CSRC, f"{name}.cu")
    deps = [os.path.join(CSRC, h) for h in headers]
    return Target(name, [src, *deps],
                  lambda out: [nvcc(), *NVCC_FLAGS, "-o", out, src])


# one library per source (rebuilt when it or a header it includes is newer);
# ``build(TARGETS)`` compiles the stale ones in parallel, one nvcc each
TARGETS = (_target("bsr_spmm", ("tile_sparse.cuh",)),
           _target("coo_segmm"),
           _target("bsr_dynamic", ("tf32x3.cuh", "tile_sparse.cuh")),
           _target("att_bsr", ("tf32x3.cuh", "tile_sparse.cuh")),
           _target("diag_spmm", ("tile_sparse.cuh",)), _target("dropout"))


def function(lib: str, name: str, argtypes: list):
    """C function ``name`` of kernel library ``lib`` (built first if stale),
    declared with ``argtypes`` and returning a ``cudaError_t`` as int."""
    fn = _fns.get((lib, name))
    if fn is None:
        t = next(t for t in TARGETS if t.name == lib)
        build([t])
        fn = getattr(ctypes.CDLL(t.path), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _fns[(lib, name)] = fn
    return fn


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError "
                           f"{rc}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> None:
    """Validate an operand before its pointer goes to a kernel."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
