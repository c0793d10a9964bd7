#!/usr/bin/env python3
"""Design choices of K8, K5, K7's walks and the straggler sum, each against
its alternatives, on one GPU.

    python3 scripts/torch_design_variants.py    # from the repository root

* K8 (``diag_spmm``): the committed walk starts the slab copy with the tile
  read (``DIAG``); the alternative starts it after the vote, as the other
  walks do.
* K5 (``dyn_grad_blocks``): the committed kernel waits for each chunk's
  wgmmas before the next chunk is issued (two shared-memory stages); the
  alternative keeps one wgmma group in flight across chunks (three stages).
* K7f (``att_fwd``, the rows walk): the committed walk works a tile
  entry's ``pe`` out only where the ballot found a non-zero; the
  alternative works it out ahead of the ballot, as the columns walk does.
* K7bt's ``dx`` (the columns walk): the committed walk works out the four
  values of a float4 before its four ballots; the alternative works each
  out after its ballot, as the rows walk does.  Both K7 alternatives print
  their registers and spilled bytes beside the committed walk's.
* K7's score-gradient pass (``att_bwd_scores``' first kernel): the
  committed pass runs one CTA per tile, forms ⟨g_i, x_j⟩ for the whole
  tile on the tensor cores (3xTF32), masks it and writes row and column
  partials; one alternative runs one CTA per block row over its tiles with
  the row sums in registers (``dsdst`` written by the pass); another reads
  the mask from device memory in the epilogue instead of copying it into
  shared memory during the product; another starts that copy inside the
  product's first chunk; others change the epilogue (the column sums
  reduce-scattered over the lane groups, the exp as ``__expf``, a branch
  per entry that takes the exp only where the mask is set); the last,
  ``scripts/variants/att_scores_sampled.cu``, forms ⟨g_i, x_j⟩ only at
  the mask's entries on the CUDA cores, one CTA per block row and
  128-feature slice, the slices summed after it (in its time).  All print
  registers and spills.  Two diagnostics, timed but not checked (their
  results are wrong by design), split the pass's time: the copies and the
  product without the epilogue, and the tile's copy started after the
  product.
* The straggler segment sum (K3, K3w, K6; ``csrc/coo_segmm.cu``), on the
  bench graph's straggler CSR (``chip_smoke.make_graph`` through the
  port's GAT ingest: 169,472 rows, 232,718 edges).  First each form on
  its path widths (K3 at F = 128 / 512, K3w at F = 40 / 64 and on the
  transpose CSR at F=512, K6 at F = 128 / 512), the kernel before its
  redesign (``scripts/variants/coo_segmm_warp_per_row.cu``: one warp per
  (row, 128-float chunk), the runtime weights formed before it by an
  elementwise pass, as its wrapper did) against the committed wrapper,
  in the order old, new, new, old: device time (``chip_smoke.device_ms``)
  of the old kernel alone and with its weight pass, and of the new one;
  and the time with each wrapper's host work (``chip_smoke.cuda_ms``).
  Then the committed design's steps at F = 40, 64, 128 and 512 on K3w's
  forward (runtime weights): lane groups of 8, 16 or 32 lanes with
  several rows a warp but every group reading its own row pointers and
  edges from device memory and one gather in flight ("rows a warp
  only"); plus the CTA's staged CSR slice ("staged"); plus U = 2 and the
  committed U = 4 gathers in flight.  Beside them its neighbours: the
  edges read unstaged at U = 4; 4 floats a lane (16, 32 lanes at F = 64,
  128) with 128 or 256 threads; 256 threads; 2 or 8 rows a group (the
  committed 4 give 64 rows a CTA at F <= 64).  Each is timed twice (in
  order, then in reverse).

Each alternative but the last K7 one and the old segment sum is the
committed source with a few textual edits; all are built with ``nvcc``
into ``build/fitgnn_tpu_torch/variants/``; the script fails if an edit no
longer applies.  ``--segmm-only`` runs the segment sum's section alone.
The other inputs are synthetic at the bench graph's shapes, made on the
card from seed 0: 1,324 diagonal blocks of 4.5% fill (one empty) with
``init``, at F = 128, 512 and 512 transposed; 2,192 tile
pairs sorted by block row over 1,324 block rows at F = 128, 512 and 101
(K5), and as presence tiles of 3.04% fill with unit-normal scores,
features and cotangents at F = 128 and 512 (K7).
Each result is checked against the plain version (rtol 1e-4, atol
1e-4·max|ref|) and timed with CUDA events (20 launches after 3).  Prints
the card's name and power limit, one line per shape, then one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (cuda_ms, device_ms, make_graph,  # noqa
                        ptxas_entries)
from fitgnn_tpu_torch.ops import (att_bsr, bsr_dynamic, coo_segmm,  # noqa
                                  diag_spmm, kernels)
from fitgnn_tpu_torch.ops.bsr_dynamic import build_dyn_plan  # noqa

OUT = os.path.join(ROOT, "build", "fitgnn_tpu_torch", "variants")
NB = 1_324
TILES = 2_192


def edited(src: str, edits: list) -> str:
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"edit no longer applies: {old!r}")
        src = src.replace(old, new)
    return src


def build_libraries(specs: dict) -> dict:
    """Builds each ``name: (files, main)`` of ``specs``, all in parallel:
    ``files`` (name -> text) go into a directory of their own and ``main``
    is compiled; returns each library, loaded."""
    procs = {}
    for name, (files, main) in specs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        lib = os.path.join(d, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
             os.path.join(d, main)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        with open(os.path.join(OUT, name, f"lib{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def c_function(lib, fn: str, argtypes):
    c = getattr(lib, fn)
    c.restype = ctypes.c_int
    c.argtypes = argtypes
    return c


def build_variant(name: str, files: dict, main: str, fn: str, argtypes):
    """Builds one variant (``build_libraries``) and returns its C function
    ``fn``."""
    return c_function(build_libraries({name: (files, main)})[name], fn,
                      argtypes)


def read(rel: str) -> str:
    with open(os.path.join(ROOT, "fitgnn_tpu_torch", "csrc", rel)) as f:
        return f.read()


def ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check(name: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    torch.testing.assert_close(got, ref, rtol=1e-4,
                               atol=1e-4 * float(ref.abs().max()),
                               msg=lambda m: f"{name}: {m}")


def k8_late():
    """The walk with the DIAG slab copy started after the vote."""
    walk = edited(read("tile_sparse.cuh"), [
        ("  if (DIAG) start_slab<VEC>(xs, x + r * BLK * feat, f0, feat, "
         "tid);\n", ""),
        ("      if (!DIAG) {\n        start_slab<VEC>", "      {\n"
         "        start_slab<VEC>")])
    return build_variant("k8_late", {"tile_sparse.cuh": walk,
                                     "diag_spmm.cu": read("diag_spmm.cu")},
                         "diag_spmm.cu", "fitgnn_diag_spmm",
                         diag_spmm._ARGTYPES)


def k5_three_stages():
    """K5 with three stages and one wgmma group left in flight."""
    src = edited(read("tf32x3.cuh"), [
        ("constexpr int SMEM = 2 * STAGE", "constexpr int SMEM = 3 * STAGE"),
        ("float* s = sm + (c & 1) * STAGE;", "float* s = sm + (c % 3) * STAGE;"),
        ('''    asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
    fence_acc(d);
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
  }
''', '''    asm volatile("wgmma.wait_group.sync.aligned 1;\\n" ::: "memory");
    fence_acc(d);
    asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");
    __syncthreads();
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\\n" ::: "memory");
  fence_acc(d);
''')])
    return build_variant("k5_three_stages", {
        "bsr_dynamic.cu": read("bsr_dynamic.cu"), "tf32x3.cuh": src,
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "bsr_dynamic.cu", "fitgnn_dyn_grad_blocks",
        bsr_dynamic._GRAD_ARGTYPES)


def k7_variant(name: str, edits: list):
    """K7's walk entry built with ``tile_sparse.cuh`` edited."""
    return build_variant(name, {
        "tile_sparse.cuh": edited(read("tile_sparse.cuh"), edits),
        "tf32x3.cuh": read("tf32x3.cuh"), "att_bsr.cu": read("att_bsr.cu")},
        "att_bsr.cu", "fitgnn_att_walk",
        att_bsr._WALK_ARGTYPES)


def k7_rows_early():
    """K7f with each entry's value worked out ahead of its ballot."""
    return k7_variant("k7_rows_early", [(
        "          apply(e, [&] { return val.value(hs, e, i, m, row0, lane); "
        "}, m,\n                1.f, xs, lane, acc[i]);",
        "          const float w = val.value(hs, e, i, m, row0, lane);\n"
        "          apply(e, [&] { return w; }, m, 1.f, xs, lane, acc[i]);")])


def k7_cols_late():
    """K7bt's dx with each value worked out after its own ballot."""
    edits = [(f"          apply(v.{c}, [&] {{ return w[{u}]; }}, m, st, xs, "
              f"lane, acc[4 * qd + {u}]);",
              f"          apply(v.{c}, [&] {{ return val.value(hs, v.{c}, "
              f"4 * qd + {u}, m, row0, lane); }}, m, st, xs, lane, "
              f"acc[4 * qd + {u}]);") for u, c in enumerate("xyzw")]
    return k7_variant("k7_cols_late", edits)


def k7_registers(log: str, what: str = "Scores") -> dict:
    return {k: (n, spill) for k, n, spill in ptxas_entries(log)
            if what in k}


# blocks, row_splits, cols, ssrc, sdst, m, dden, g, x, rpart, cpart,
# num_row_blocks, k_all, feat, slope, stream
_SAMPLED_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 3
                     + [ctypes.c_float, ctypes.c_void_p])


def k7_per_row():
    """The score pass with one CTA per block row walking its tiles, the
    row sums kept in registers across them; ``rows`` carries the forward
    walk's ``row_splits`` and ``rpart`` is ``dsdst``."""
    return build_variant("k7_per_row", {
        "att_bsr.cu": edited(read("att_bsr.cu"), [
            ("  const int64_t k = blockIdx.x;\n  const int64_t r = rows[k];\n"
             "  const int64_t c = cols[k];\n",
             "  const int64_t r = blockIdx.x;\n  float rs0 = 0.f, rs1 = 0.f;\n"
             "  for (int64_t k = rows[r]; k < rows[r + 1]; ++k) {\n"
             "  const int64_t c = cols[k];\n"),
            ("  float rs0 = 0.f, rs1 = 0.f;\n#pragma unroll\n", "#pragma unroll\n"),
            ("""  if ((lane & 3) == 0) {
    rpart[k * BLK + i0] = rs0;
    rpart[k * BLK + i0 + 8] = rs1;
  }
""", ""),
            ("  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);\n"
             "  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);\n"
             "  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);\n"
             "  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);\n", ""),
            ("    cpart[k * BLK + tid] = v;\n  }\n}\n",
             """    cpart[k * BLK + tid] = v;
  }
  __syncthreads();
  }
  const int i0 = warp * 16 + (lane >> 2);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
  if ((lane & 3) == 0) {
    rpart[r * BLK + i0] = rs0;
    rpart[r * BLK + i0 + 8] = rs1;
  }
}
""")]),
        "tf32x3.cuh": read("tf32x3.cuh"),
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_bsr.cu", "fitgnn_att_scores", att_bsr._SCORES_ARGTYPES)


def k7_mask_global():
    """The score pass with the mask read from device memory in the
    epilogue, into the accumulator's positions, instead of copied into
    shared memory during the product."""
    return build_variant("k7_mask_global", {
        "att_bsr.cu": edited(read("att_bsr.cu"), [
            ("""#pragma unroll
  for (int u = 0; u < SC_TILE / 4 / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / 4);
    sparse::cp_async16(ts + i * BLK + 4 * ((q % (BLK / 4)) ^ (i & 7)),
                       tile + 4 * q, 16);
  }
""", ""),
            ("    const int at = i0 * BLK + 4 * ((col >> 2) ^ key) + (col & 3);\n"
             "    const float2 k0 = *reinterpret_cast<const float2*>(ts + at);\n"
             "    const float2 k1 = *reinterpret_cast<const float2*>(ts + at + 8 * BLK);",
             "    const int at = i0 * BLK + col;\n"
             "    const float2 k0 = __ldg(reinterpret_cast<const float2*>(tile + at));\n"
             "    const float2 k1 = __ldg(reinterpret_cast<const float2*>(tile + at + 8 * BLK));")]),
        "tf32x3.cuh": read("tf32x3.cuh"),
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_bsr.cu", "fitgnn_att_scores", att_bsr._SCORES_ARGTYPES)


_SHUFFLES = """#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      d[4 * j] += __shfl_xor_sync(0xffffffffu, d[4 * j], o);
      d[4 * j + 1] += __shfl_xor_sync(0xffffffffu, d[4 * j + 1], o);
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      *reinterpret_cast<float2*>(cs + warp * BLK + 8 * j + 2 * lane) =
          make_float2(d[4 * j], d[4 * j + 1]);
    }
  }
"""
# reduce-scatter over the 8 lane groups: each round a lane keeps half its
# values and sends the other half, 16 + 8 + 4 shuffles instead of 96
_SCATTER = """  float u[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) u[t] = d[4 * (t >> 1) + (t & 1)];
#pragma unroll
  for (int rd = 0; rd < 3; ++rd) {
    const bool up = (lane >> (2 + rd)) & 1;
    const int half = 16 >> rd;
#pragma unroll
    for (int t = 0; t < half; ++t) {
      const float send = up ? u[t] : u[t + half];
      const float keep = up ? u[t + half] : u[t];
      u[t] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << rd);
    }
  }
  const int t0 = 16 * ((lane >> 2) & 1) + 8 * ((lane >> 3) & 1)
                 + 4 * ((lane >> 4) & 1);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int tt = t0 + t;
    cs[warp * BLK + 8 * (tt >> 1) + 2 * (lane & 3) + (tt & 1)] = u[t];
  }
"""


_SELECT = """  const bool set = mask != 0.f;
  const float v = (acc + dd) * expf(set ? leaky(raw, slope) - m : 0.f);
  return set ? (raw >= 0.f ? v : slope * v) : 0.f;
"""
# a branch per entry: the exp is taken only where the mask is set
_BRANCH = """  if (mask == 0.f) return 0.f;
  const float v = (acc + dd) * expf(leaky(raw, slope) - m);
  return raw >= 0.f ? v : slope * v;
"""


def k7_epilogue(name: str, scatter: bool, fast_exp: bool,
                branch: bool = False):
    """The score pass with the column sums reduce-scattered over the lane
    groups, the exp taken as __expf, and/or a branch per entry in place of
    the selects."""
    edits = []
    if scatter:
        edits.append((_SHUFFLES, _SCATTER))
    if branch:
        edits.append((_SELECT, _BRANCH))
    if fast_exp:
        edits.append(("* expf(", "* __expf("))
    return build_variant(name, {
        "att_bsr.cu": edited(read("att_bsr.cu"), edits),
        "tf32x3.cuh": read("tf32x3.cuh"),
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_bsr.cu", "fitgnn_att_scores", att_bsr._SCORES_ARGTYPES)


_TILE_COPY = """#pragma unroll
  for (int u = 0; u < SC_TILE / 4 / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / 4);
    sparse::cp_async16(ts + i * BLK + 4 * ((q % (BLK / 4)) ^ (i & 7)),
                       tile + 4 * q, 16);
  }
"""


def k7_diagnostic(name: str):
    """Timing only (wrong results): ``no_epilogue`` keeps the pass's copies
    and product and sums the accumulators into one store; ``copy_late``
    starts the tile's copy after the product instead of before it."""
    src = read("att_bsr.cu")
    if name == "no_epilogue":
        a = src.index("  // the accumulator's rows i0 and i0 + 8")
        b = src.index("    cpart[k * BLK + tid] = v;\n  }\n}\n")
        src = (src[:a] + "  float v = 0.f;\n#pragma unroll\n"
               "  for (int j = 0; j < 64; ++j) v += d[j];\n"
               "  cpart[k * BLK + (tid & 127)] = v;\n  rpart[k] = ts[tid];\n}\n"
               + src[b + len("    cpart[k * BLK + tid] = v;\n  }\n}\n"):])
    else:
        src = edited(src, [
            (_TILE_COPY, ""),
            ("  sparse::cp_async_wait<0>();\n  __syncthreads();\n\n"
             "  // the accumulator's rows",
             _TILE_COPY + "  sparse::cp_async_commit();\n"
             "  sparse::cp_async_wait<0>();\n  __syncthreads();\n\n"
             "  // the accumulator's rows")])
    return build_variant(f"k7_{name}", {
        "att_bsr.cu": src, "tf32x3.cuh": read("tf32x3.cuh"),
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_bsr.cu", "fitgnn_att_scores", att_bsr._SCORES_ARGTYPES)


def k7_copy_in_loop():
    """The score pass with the tile's copy started inside the product's
    first chunk, after its wgmmas are issued (a hook in tf32x3.cuh)."""
    header = edited(read("tf32x3.cuh"), [
        ("template <bool VEC>\n__device__ __forceinline__ void product(",
         "template <bool VEC, class Hook>\n"
         "__device__ __forceinline__ void product("),
        ("                                        int64_t feat, int tid) {",
         "                                        int64_t feat, int tid,\n"
         "                                        Hook hook) {"),
        ("""    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    fence_acc(d);
""", """    asm volatile("wgmma.commit_group.sync.aligned;\\n" ::: "memory");
    fence_acc(d);
    if (c == 0) hook();
""")])
    src = edited(read("att_bsr.cu"), [
        (_TILE_COPY, ""),
        ("""  tf32x3::product<VEC>(d, sm, g + r * BLK * feat, x + c * BLK * feat, feat,
                       tid);""", """  tf32x3::product<VEC>(d, sm, g + r * BLK * feat, x + c * BLK * feat, feat,
                       tid, [&] {
""" + _TILE_COPY + """  sparse::cp_async_commit();
  });""")])
    return build_variant("k7_copy_in_loop", {
        "att_bsr.cu": src, "tf32x3.cuh": header,
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_bsr.cu", "fitgnn_att_scores", att_bsr._SCORES_ARGTYPES)


def k7_sampled():
    """The score pass sampled at the mask on the CUDA cores."""
    with open(os.path.join(ROOT, "scripts", "variants",
                           "att_scores_sampled.cu")) as f:
        src = f.read()
    return build_variant("k7_sampled", {
        "att_scores_sampled.cu": src,
        "tile_sparse.cuh": read("tile_sparse.cuh")},
        "att_scores_sampled.cu", "fitgnn_att_scores_sampled",
        _SAMPLED_ARGTYPES)


# the old segment sum's entries: row_ptr, senders, weights, x, out,
# (den,) num_rows, feat, stream
_OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 2 + [
    ctypes.c_void_p]
_OLD_DEN_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2 + [
    ctypes.c_void_p]
_UNSTAGED = [
    ("const int nwin = max(1, (hi - lo + WINDOW - 1) / WINDOW);",
     "const int nwin = 1;"),
    ("const int we = min(hi, wb + WINDOW);", "const int we = hi;"),
    ("if (nwin > 1 || base == 0) {", "if (false) {"),
    ("s[j] = j < left ? s_send[e + j - wb] : 0;",
     "s[j] = j < left ? senders[e + j] : 0;"),
    ("w[j] = j < left ? s_w[e + j - wb] : 0.f;",
     "w[j] = j < left ? edge_weight(weights, w_edge, perm, e + j) : 0.f;")]


def _set(name: str, value: int) -> list:
    """Sets one of the kernel's constants (its committed value first)."""
    committed = {"U": 4, "ROWS": 4, "V": 2, "THREADS": 128}[name]
    return [(f"constexpr int {name} = {committed};",
             f"constexpr int {name} = {value};")]


# the committed design's steps first, then its neighbours
SEGMM_VARIANTS = {
    "rows a warp only": _set("U", 1) + _UNSTAGED,
    "staged": _set("U", 1),
    "staged, U=2": _set("U", 2),
    "unstaged, U=4": _UNSTAGED,
    "4 floats a lane": _set("V", 1),
    "4 floats a lane, 256 threads": _set("V", 1) + _set("THREADS", 256),
    "256 threads": _set("THREADS", 256),
    "2 rows a group": _set("ROWS", 2),
    "8 rows a group": _set("ROWS", 8)}


def segmm_section(dev) -> list:
    """The segment sum's forms, old against new, then the design's steps
    (the module docstring says which)."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    names = {k: "segmm_" + "".join(c if c.isalnum() else "_" for c in k)
             for k in ("old", *SEGMM_VARIANTS)}
    with open(os.path.join(ROOT, "scripts", "variants",
                           "coo_segmm_warp_per_row.cu")) as f:
        specs = {names["old"]: ({"coo_segmm.cu": f.read()}, "coo_segmm.cu")}
    for k, edits in SEGMM_VARIANTS.items():
        specs[names[k]] = ({"coo_segmm.cu": edited(read("coo_segmm.cu"),
                                                    edits)}, "coo_segmm.cu")
    libs = build_libraries(specs)
    regs = {k: max(n for _, n, _ in ptxas_entries(os.path.join(
        OUT, v, f"lib{v}.log"))) for k, v in names.items()}
    committed = next(t for t in kernels.TARGETS if t.name == "coo_segmm")
    coo_segmm.launch_shape(64)                   # builds the committed one
    regs["committed"] = max(n for _, n, _ in ptxas_entries(
        committed.log_path))
    print(f"segmm registers (most over the instantiations): {regs}")
    old = c_function(libs[names["old"]], "fitgnn_segmm_spmm", _OLD_ARGTYPES)
    old_den = c_function(libs[names["old"]], "fitgnn_segmm_spmm_den",
                         _OLD_DEN_ARGTYPES)
    new = {k: c_function(libs[names[k]], "fitgnn_segmm_spmm",
                         coo_segmm._ARGTYPES) for k in SEGMM_VARIANTS}

    x, s, r, y, train = make_graph()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GATConv", seed=0)
    h = g.aux
    m, mt = h.segmm.to(dev), h.t_segmm.to(dev)
    perm = h.t_edge_perm.to(dev)
    n, e = m.num_nodes, m.senders.shape[0]
    per_row = m.row_ptr.diff()
    print(f"straggler CSR: {n} rows, {e} edges, "
          f"{int((per_row == 0).sum())} rows empty, at most "
          f"{int(per_row.max())} edges a row")
    gen = torch.Generator(device=dev).manual_seed(0)
    w_edge = torch.rand(e, generator=gen, device=dev)
    p, stream = kernels.ptr, kernels.stream(dev)
    null = ctypes.c_void_p(None)

    def old_run(csr, w, xx, den=False):
        out = torch.empty_like(xx)
        if den:
            d = torch.empty(n, device=dev)
            kernels.check(old_den(p(csr.row_ptr), p(csr.senders), p(w),
                                  p(xx), p(out), p(d), n, xx.shape[1],
                                  stream), "old segmm den")
            return out, d
        kernels.check(old(p(csr.row_ptr), p(csr.senders), p(w), p(xx),
                          p(out), n, xx.shape[1], stream), "old segmm")
        return out

    results = []
    forms = (("K3", 128), ("K3", 512), ("K3w", 40), ("K3w", 64),
             ("K3w transpose", 512), ("K6", 128), ("K6", 512))
    for form, feat in forms:
        xx = torch.randn((n, feat), generator=gen, device=dev)
        csr = mt if form == "K3w transpose" else m
        pm = perm if form == "K3w transpose" else None
        den = form == "K6"

        def weight_pass():
            """The old wrapper's edge weights (K3's are the static ones)."""
            if form == "K3":
                return csr.weights
            w = w_edge if pm is None else w_edge[pm.long()]
            return (w * csr.weights).contiguous()

        def old_form():
            return old_run(csr, weight_pass(), xx, den)

        w_old = weight_pass()

        def old_kernel():
            return old_run(csr, w_old, xx, den)

        new_form = {
            "K3": lambda: coo_segmm.segmm_spmm(csr, xx),
            "K6": lambda: coo_segmm.segmm_weighted_den_raw(csr, w_edge, xx)
        }.get(form, lambda: coo_segmm.segmm_weighted_raw(csr, w_edge, xx,
                                                         pm))

        got, ref = new_form(), old_form()
        for a, b in zip(got if den else (got,), ref if den else (ref,)):
            check(f"{form} F={feat} new vs old", a, b)
        row = {"form": form, "F": feat}
        for what, timer in (("device_ms", device_ms), ("wrapper_ms",
                                                       cuda_ms)):
            t = {"old": [], "old_kernel": [], "new": []}
            for which in ("old", "new", "new", "old"):
                if which == "old":
                    t["old"].append(timer(old_form, 20))
                    t["old_kernel"].append(timer(old_kernel, 20))
                else:
                    t["new"].append(timer(new_form, 20))
            row[what] = t
        results.append(row)
        print(results[-1])

    for feat in (40, 64, 128, 512):
        xx = torch.randn((n, feat), generator=gen, device=dev)
        ref = coo_segmm.segmm_weighted_raw_plain(m, w_edge, xx)

        def launcher(fn):
            def run():
                out = torch.empty_like(xx)
                kernels.check(fn(p(m.row_ptr), p(m.senders), p(m.weights),
                                 p(w_edge), null, p(xx), p(out), null, n,
                                 feat, stream), "segmm variant")
                return out
            return run

        w_old = (w_edge * m.weights).contiguous()
        runs = {"old kernel alone": lambda: old_run(m, w_old, xx),
                **{k: launcher(fn) for k, fn in new.items()},
                "committed": lambda: coo_segmm.segmm_weighted_raw(
                    m, w_edge, xx)}
        for k, fn in runs.items():
            check(f"K3w F={feat} {k}", fn(), ref)
        order = list(runs)
        t = {k: [] for k in order}
        for seq in (order, order[::-1]):
            for k in seq:
                t[k].append(device_ms(runs[k], 20))
        results.append({"kernel": "K3w variants", "F": feat,
                        "device_ms": t, "registers": regs})
        print(results[-1])
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if "--segmm-only" in sys.argv[1:]:
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "results": segmm_section(dev)}))
        return 0
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []

    late = k8_late()
    blocks = torch.where(
        torch.rand((NB, 128, 128), generator=gen, device=dev) < 0.045,
        torch.rand((NB, 128, 128), generator=gen, device=dev), 0.0)
    blocks[7] = 0.0
    for feat, trans in ((128, False), (512, False), (512, True)):
        x = torch.randn((NB * 128, feat), generator=gen, device=dev)
        init = torch.randn((NB * 128, feat), generator=gen, device=dev)

        def run_late():
            out = torch.empty_like(x)
            kernels.check(late(kernels.ptr(blocks), kernels.ptr(x),
                               kernels.ptr(init), kernels.ptr(out), NB, feat,
                               int(trans), kernels.stream(dev)), "k8_late")
            return out

        def run_kept():
            return diag_spmm.diag_spmm(blocks, x, 4, trans, init)

        ref = diag_spmm.diag_spmm_plain(blocks, x, 4, trans, init)
        check("K8 kept", run_kept(), ref)
        check("K8 late slab", run_late(), ref)
        results.append({"kernel": "K8", "F": feat, "transpose": trans,
                        "kept_ms": ms(run_kept), "late_slab_ms": ms(run_late)})
        print(results[-1])

    three = k5_three_stages()
    g = torch.Generator().manual_seed(1)
    rows = torch.sort(torch.randint(0, NB, (TILES,), generator=g)).values
    rows = rows.int().to(dev)
    cols = torch.randint(0, NB, (TILES,), generator=g).int().to(dev)
    for feat in (128, 512, 101):
        x = torch.randn((NB * 128, feat), generator=gen, device=dev)
        gr = torch.randn((NB * 128, feat), generator=gen, device=dev)

        def run_three():
            out = torch.empty((TILES, 128, 128), device=dev)
            kernels.check(three(kernels.ptr(rows), kernels.ptr(cols),
                                kernels.ptr(gr), kernels.ptr(x),
                                kernels.ptr(out), TILES, feat,
                                kernels.stream(dev)), "k5_three_stages")
            return out

        def run_kept():
            return bsr_dynamic.dyn_grad_blocks(rows, cols, gr, x)

        ref = bsr_dynamic.dyn_grad_blocks_plain(rows, cols, gr, x)
        check("K5 kept", run_kept(), ref)
        check("K5 three stages", run_three(), ref)
        results.append({"kernel": "K5", "F": feat, "kept_ms": ms(run_kept),
                        "three_stages_ms": ms(run_three)})
        print(results[-1])
    rows_early, cols_late = k7_rows_early(), k7_cols_late()
    sampled, per_row = k7_sampled(), k7_per_row()
    mask_global = k7_mask_global()
    epilogues = {"scatter": k7_epilogue("k7_scatter", True, False),
                 "fast_exp": k7_epilogue("k7_fast_exp", False, True),
                 "copy_in_loop": k7_copy_in_loop(),
                 "branch": k7_epilogue("k7_branch", False, False, True)}
    diagnostics = {k: k7_diagnostic(k) for k in ("no_epilogue",
                                                  "copy_late")}
    kept = kernels.function("att_bsr", "fitgnn_att_walk",
                            att_bsr._WALK_ARGTYPES)
    target = next(t for t in kernels.TARGETS if t.name == "att_bsr")
    regs = {"kept": k7_registers(target.log_path),
            "rows_early": k7_registers(os.path.join(
                OUT, "k7_rows_early", "libk7_rows_early.log")),
            "cols_late": k7_registers(os.path.join(
                OUT, "k7_cols_late", "libk7_cols_late.log")),
            "scores_kept": k7_registers(target.log_path, "att_scores"),
            "scores_sampled": k7_registers(os.path.join(
                OUT, "k7_sampled", "libk7_sampled.log"), "att_scores"),
            "scores_per_row": k7_registers(os.path.join(
                OUT, "k7_per_row", "libk7_per_row.log"), "att_scores"),
            "scores_mask_global": k7_registers(os.path.join(
                OUT, "k7_mask_global", "libk7_mask_global.log"),
                "att_scores")}
    print(json.dumps(regs))
    blocks = (torch.rand((TILES, 128, 128), generator=gen, device=dev)
              < 0.0304).float()
    plan = build_dyn_plan(rows.cpu().numpy(), cols.cpu().numpy(),
                          NB).to(dev)
    ssrc, sdst = (torch.randn(NB * 128, generator=gen, device=dev)
                  for _ in range(2))
    mg = (sdst + ssrc.max()).clamp_min(0.0)
    null, stream = ctypes.c_void_p(None), kernels.stream(dev)
    p = kernels.ptr
    for feat in (128, 512):
        x = torch.randn((NB * 128, feat), generator=gen, device=dev)

        def fwd(fn=None):
            if fn is None:
                return att_bsr.att_fwd(rows, cols, plan, blocks, ssrc, sdst,
                                       mg, x, 0.2)
            out, den = torch.empty_like(x), torch.empty_like(ssrc)
            kernels.check(fn(p(blocks), p(plan.row_splits), null, null,
                             p(cols), p(ssrc), p(sdst), p(mg), p(x), p(out),
                             p(den), NB, feat, 0, 0.2, stream), "k7 fwd")
            return out, den

        def dx(fn):
            out = torch.empty_like(x)
            kernels.check(fn(p(blocks), p(plan.t_row_splits), p(plan.t_sel),
                             p(plan.t_scale), p(plan.t_cols), p(ssrc),
                             p(sdst), p(mg), p(x), p(out), null, NB, feat, 1,
                             0.2, stream), "k7 dx")
            return out

        num_p, den_p = att_bsr.att_fwd_plain(rows, cols, plan, blocks, ssrc,
                                             sdst, mg, x, 0.2)
        dx_p = att_bsr.att_bwd_t_plain(plan, blocks, ssrc, sdst, mg, x, x,
                                       sdst, 0.2, need_dssrc=False)[0]
        for what, fn in (("kept", None), ("rows early", rows_early)):
            num, den = fwd(fn)
            check(f"K7f {what} num", num, num_p)
            check(f"K7f {what} den", den, den_p)
        check("K7bt dx kept", dx(kept), dx_p)
        check("K7bt dx cols late", dx(cols_late), dx_p)
        results.append({"kernel": "K7f", "F": feat, "kept_ms": ms(fwd),
                        "rows_early_ms": ms(lambda: fwd(rows_early))})
        print(results[-1])
        results.append({"kernel": "K7bt dx", "F": feat,
                        "kept_ms": ms(lambda: dx(kept)),
                        "cols_late_ms": ms(lambda: dx(cols_late))})
        print(results[-1])

        # the score pass against the sampled alternative
        gr = torch.randn((NB * 128, feat), generator=gen, device=dev)
        dden = torch.randn(NB * 128, generator=gen, device=dev)
        slices = (feat + 127) // 128

        def scores():
            return att_bsr._launch_scores("att_bwd_scores", dev, blocks,
                                          rows, cols, ssrc, sdst, mg, gr, x,
                                          dden, 0.2)

        def run_tiles(fn, what):
            def run():
                cp, rp = torch.empty((2, TILES, 128), device=dev)
                kernels.check(fn(p(blocks), p(rows), p(cols), p(ssrc),
                                 p(sdst), p(mg), p(dden), p(gr), p(x),
                                 p(cp), p(rp), TILES, feat, 0.2, stream),
                              what)
                return cp, rp
            return run

        def scores_per_row():
            cp = torch.empty((TILES, 128), device=dev)
            dsdst = torch.empty(NB * 128, device=dev)
            kernels.check(per_row(p(blocks), p(plan.row_splits), p(cols),
                                  p(ssrc), p(sdst), p(mg), p(dden), p(gr),
                                  p(x), p(cp), p(dsdst), NB, feat, 0.2,
                                  stream), "k7 per row")
            return cp, dsdst

        def scores_sampled():
            rp = torch.empty((slices, NB * 128), device=dev)
            cp = torch.empty((slices, TILES, 128), device=dev)
            kernels.check(sampled(p(blocks), p(plan.row_splits), p(cols),
                                  p(ssrc), p(sdst), p(mg), p(dden), p(gr),
                                  p(x), p(rp), p(cp), NB, TILES, feat, 0.2,
                                  stream), "k7 sampled")
            return cp.sum(0), rp.sum(0)

        part_p, rpart_p = att_bsr.att_scores_plain(
            rows, cols, plan, blocks, ssrc, sdst, mg, gr, x, dden, 0.2)
        dsdst_p = att_bsr.att_sums_plain(plan, part_p, rpart_p)[1]
        scores_mask_global = run_tiles(mask_global, "mask global")
        epi = {k: run_tiles(f, k) for k, f in epilogues.items()}
        for what, fn in (("kept", scores), ("sampled", scores_sampled),
                         ("per row", scores_per_row),
                         ("mask global", scores_mask_global), *epi.items()):
            part, dsdst = fn()
            if what not in ("sampled", "per row"):   # row partials
                dsdst = att_bsr.att_sums_plain(plan, part, dsdst)[1]
            check(f"K7 scores {what} partials", part, part_p)
            check(f"K7 scores {what} dsdst", dsdst, dsdst_p)
        del part_p, rpart_p, dsdst_p
        results.append({"kernel": "K7 score pass", "F": feat,
                        "kept_ms": ms(scores),
                        "sampled_ms": ms(scores_sampled),
                        "per_row_ms": ms(scores_per_row),
                        "mask_global_ms": ms(scores_mask_global),
                        **{f"{k}_ms": ms(f) for k, f in epi.items()},
                        **{f"diagnostic_{k}_ms": ms(run_tiles(f, k))
                           for k, f in diagnostics.items()}})
        print(results[-1])
    results.extend(segmm_section(dev))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "registers": regs, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
