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
           _target("bsr_dynamic", ("bf16x1.cuh", "tf32x3.cuh",
                                   "tile_sparse.cuh")),
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


def entry(name: str, tiles: torch.Tensor) -> str:
    """C entry ``name``, or its ``_bf16`` twin for bf16 tiles."""
    return name + "_bf16" if tiles.dtype == torch.bfloat16 else name


def count(fn, tiles: torch.Tensor) -> None:
    """One launch of wrapper ``fn``'s form for the tiles' type: counted in
    ``fn.launches_bf16`` for bf16 tiles, else in ``fn.launches``."""
    if tiles.dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def narrow(what: str, x: torch.Tensor) -> bool:
    """Whether ``x`` holds bf16 activations, which a wrapper hands to its
    kernel's bf16-activation form (K1a, K1bfa, K3a, K4a, K4ᵀa, K5a, K11a)
    or to
    ``widened``; False for f32.  On the card any other type raises
    ``ValueError``: the kernels take f32 and bf16 activations only
    (ROADMAP.md §3).  A CPU tensor of another type goes to the plain
    version, as before."""
    if x.dtype == torch.bfloat16:
        return True
    if x.device.type == "cuda" and x.dtype != torch.float32:
        raise ValueError(f"{what}: activations must be float32 or bfloat16, "
                         f"got {x.dtype} (ROADMAP.md §3)")
    return False


def widened(fn, *acts: torch.Tensor, rounds=(0,)):
    """The widened route of a kernel form with no bf16-activation form of
    its own: ``fn`` on ``acts`` widened to f32 (exact), which launches the
    form's f32-activation kernel (counted in its usual count) on the card
    and its plain version on the CPU, then each output at ``rounds`` (the
    output itself when ``fn`` returns one tensor) rounded to bf16 once;
    the others (f32 sums such as a softmax denominator) stay f32.  Where a
    Pallas kernel rounds each tile's or chunk's partial into a bf16 block,
    this rounds the f32 total once (ROADMAP.md §3)."""
    out = fn(*(a if a is None else a.float() for a in acts))
    if isinstance(out, torch.Tensor):
        return out.to(torch.bfloat16) if rounds else out
    return tuple(o.to(torch.bfloat16) if i in rounds and o is not None
                 else o for i, o in enumerate(out))


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> None:
    """Validate an operand before its pointer goes to a kernel."""
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()})")
