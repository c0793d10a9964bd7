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

* The quadrant walk with occupancy words (K1, K2 and K9 at tile edge 256;
  ``csrc/tile_sparse.cuh``'s ``walk_live``), on the bench graph's
  operators at 256 (``build_optimized_graph`` for GCN, then
  ``chip_smoke.block_operators``: threshold 48, and with ``tile_group=2``
  for K9), f32 and bf16 tiles, F = 128 and 512: the walk without words
  (null words: every quadrant read and voted on), the walk that skips the
  empty quadrants but keeps the vote and starts the slab copy after it
  ("skip only"), and the committed walk, which skips them and starts each
  live quadrant's slab copy with its tile read ("skip + early slab"); on
  bf16 tiles also the committed walk with the landed slab rounded one
  value a conversion (``round_slab``) instead of two (``round_slab_pairs``;
  "single"); in the order none, skip, early, single, single, early, skip,
  none, each checked against the plain version and bit for bit against
  the walk without words.
  ``--quad-words-only`` runs this section alone, and prints the
  ``ptxas`` registers of both words forms.
* K5 on the live list at tile edge 256 (``--k5-live-only``, this section
  alone), on the bench graph's GAT plan at threshold 48 (3,115 live of
  4,696 quadrants), F = 128 and 512: the full grid (no list), the
  committed live grid (a CTA a live quadrant, each first storing the
  zeros of the gap of empty quadrants before it, one more CTA for the gap
  after the last), the same with the zeros written by a store-only pass
  of their own after the products (``K5_ZERO_PASS``, a textual edit), and
  a persistent grid, one CTA an SM walking the list, the next quadrant's
  first F-chunk loaded while the current one's accumulators are stored
  (``scripts/variants/dyn_grad_blocks_persistent.cu``); in the order
  full, kept, pass, persistent and back, each checked against the plain
  version with the list and each live form bit for bit the committed one;
  with their ``ptxas`` registers.
* K7sums (``att_sums``; ``--k7sums-only``, this section alone), on the
  score pass's partials (F=128) of the bench graph's GAT operators at tile
  edge 128 (``build_optimized_graph``'s, no words) and 256 (threshold 48,
  the plan's words): the kernel before its redesign
  (``scripts/variants/att_sums_cta_per_block.cu``: a CTA of 128 threads a
  128-row block, each tile's partials loaded and added one after another,
  every partial read) against the committed one (a warp a block, 3 slots'
  partial loads issued before their adds), with the words and without
  them (null words); a cursor handing out one partial at a time
  (``scripts/variants/att_sums_cursor.cu``); 4 and 6 slots a batch, 4
  warps a CTA (``K7SUMS_EDITS``); and two diagnostics, the stores alone
  and the range's load with the stores (timed, not checked).  Device time
  (``chip_smoke.device_ms``, 100 launches), in order and then in reverse;
  each form bit for bit the old kernel; with their ``ptxas`` registers.

Each alternative but the last K7 one, the old segment sum and K7sums's
two files is the
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
import dataclasses
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (bf16_tiles, block_operators, cuda_ms,  # noqa
                        device_ms, make_graph, ptxas_entries)
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
        ("  if (DIAG && !QUAD) start_slab<VEC>(xs, x + r * BLK * feat, f0, "
         "feat, tid);\n", ""),
        ("        if (!DIAG) {\n          start_slab<VEC>",
         "        if (true) {\n          start_slab<VEC>")])
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


# K5 on the live list with the empty quadrants zeroed by a store-only pass
# of its own after the products (a second launch over the same gaps, no
# shared memory), in place of the product CTAs' gap stores
K5_ZERO_PASS = [
    ("""    zero_quadrants(dB, b == 0 ? 0 : live[b - 1] + 1,
                   b == num_live ? num_quads : live[b], nq, tid);
""", ""),
    ("template <bool VEC, bool LIVE, bool QUAD>\n",
     """__global__ void __launch_bounds__(tf32x3::THREADS)
zero_gaps_kernel(const int32_t* __restrict__ live, float* __restrict__ dB,
                 int64_t num_live, int64_t num_quads, int nq) {
  const int64_t b = blockIdx.x;
  zero_quadrants(dB, b == 0 ? 0 : live[b - 1] + 1,
                 b == num_live ? num_quads : live[b], nq, threadIdx.x);
}

template <bool VEC, bool LIVE, bool QUAD>
"""),
    ("""        num_live, quads, nq);
  }
""", """        num_live, quads, nq);
    if (with_live) {
      zero_gaps_kernel<<<static_cast<unsigned>(num_live + 1),
                         tf32x3::THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(live), static_cast<float*>(dB),
          num_live, quads, nq);
    }
  }
""")]


def k5_live_variants() -> dict:
    """K5's live grid with a separate store-only pass for the zeros, and
    the persistent grid (``scripts/variants/dyn_grad_blocks_persistent.cu``);
    name -> C function."""
    with open(os.path.join(ROOT, "scripts", "variants",
                           "dyn_grad_blocks_persistent.cu")) as f:
        persistent = f.read()
    libs = build_libraries({
        "k5_zero_pass": ({
            "bsr_dynamic.cu": edited(read("bsr_dynamic.cu"), K5_ZERO_PASS),
            "tf32x3.cuh": read("tf32x3.cuh"),
            "tile_sparse.cuh": read("tile_sparse.cuh")}, "bsr_dynamic.cu"),
        "k5_persistent": ({
            "dyn_grad_blocks_persistent.cu": persistent,
            "tf32x3.cuh": read("tf32x3.cuh")},
            "dyn_grad_blocks_persistent.cu")})
    return {name: c_function(lib, "fitgnn_dyn_grad_blocks",
                             bsr_dynamic._GRAD_ARGTYPES)
            for name, lib in libs.items()}


def k5_live_section(dev) -> tuple:
    """K5 at edge 256 on the bench graph's GAT plan (threshold 48, its
    live list), F = 128 and 512: the full grid (no list), the committed
    live grid (the gaps zeroed by the product CTAs), the live grid with a
    store-only pass for the zeros, and the persistent grid, in the order
    full, kept, pass, persistent, persistent, pass, kept, full; each
    checked against the plain version with the list, and each live form
    bit for bit the committed one.  Returns the rows and the variants'
    registers."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from chip_smoke import NUM_NODES

    fns = k5_live_variants()
    kernels.build([t for t in kernels.TARGETS if t.name == "bsr_dynamic"])
    regs = {}
    for form, log in (
            ("kept", next(t.log_path for t in kernels.TARGETS
                          if t.name == "bsr_dynamic")),
            ("zero pass", os.path.join(OUT, "k5_zero_pass",
                                       "libk5_zero_pass.log")),
            ("persistent", os.path.join(OUT, "k5_persistent",
                                        "libk5_persistent.log"))):
        for k, n, spill in ptxas_entries(log):
            if "dyn_grad_blocks_kernel<" in k and k.endswith("true, true>") \
                    or "persistent_kernel" in k or "zero_gaps" in k:
                regs[f"{form}: {k}"] = (n, spill)
    x, s, r, y, train = make_graph()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GCNConv", seed=0)
    h = build_hybrid(g.senders.numpy().astype("int64"),
                     g.receivers.numpy().astype("int64"),
                     (g.edge_weight.numpy() > 0).astype("float32"),
                     g.num_nodes_padded, block=256, min_block_edges=48,
                     use_segmm=True, semantics="att_unit",
                     real_nodes=NUM_NODES)
    n = g.num_nodes_padded
    del g
    hd = h.to(dev)
    b, plan = hd.bsr, hd.dyn_plan
    k = b.nnz_blocks
    print(f"K5@256 live grid: {plan.live.numel()} live quadrants of "
          f"{k * 4}")
    gen = torch.Generator(device=dev).manual_seed(24)
    stream = kernels.stream(dev)
    results = []
    for feat in (128, 512):
        xx = torch.randn((n, feat), generator=gen, device=dev)
        gr = torch.randn((n, feat), generator=gen, device=dev)

        def variant(name):
            def run():
                out = torch.empty((k, 256, 256), device=dev)
                kernels.check(fns[name](
                    kernels.ptr(b.rows), kernels.ptr(b.cols),
                    kernels.ptr(plan.live), kernels.ptr(gr),
                    kernels.ptr(xx), kernels.ptr(out), k,
                    plan.live.numel(), feat, 256, stream), name)
                return out
            return run

        forms = {"full": lambda: bsr_dynamic.dyn_grad_blocks(
                     b.rows, b.cols, gr, xx, 256),
                 "kept": lambda: bsr_dynamic.dyn_grad_blocks(
                     b.rows, b.cols, gr, xx, 256, plan.live),
                 "zero_pass": variant("k5_zero_pass"),
                 "persistent": variant("k5_persistent")}
        ref = bsr_dynamic.dyn_grad_blocks_plain(b.rows, b.cols, gr, xx, 256,
                                                plan.live)
        got = {f: run() for f, run in forms.items()}
        check(f"K5@256 F={feat} kept", got["kept"], ref)
        for f in ("zero_pass", "persistent"):
            if not torch.equal(got[f], got["kept"]):
                raise RuntimeError(f"K5@256 F={feat} {f}: not the committed "
                                   "live grid bit for bit")
        del got, ref
        times = {f: [] for f in forms}
        order = ("full", "kept", "zero_pass", "persistent")
        for f in order + order[::-1]:
            times[f].append(ms(forms[f]))
        results.append({"kernel": "K5@256", "F": feat,
                        **{f"{f}_ms": sum(v) / len(v)
                           for f, v in times.items()}, "runs_ms": times})
        print(results[-1])
        del xx, gr
        torch.cuda.empty_cache()
    return results, regs


# K7sums's neighbours, each a textual edit of the committed att_bsr.cu:
# the slots a batch of loads and the warps a CTA; and two diagnostics,
# timed but not checked (their sums are wrong by design): the stores
# alone, and the range's load with the stores
K7SUMS_EDITS = {
    "slots4": [("constexpr int SUM_SLOTS = 3;",
                "constexpr int SUM_SLOTS = 4;")],
    "slots6": [("constexpr int SUM_SLOTS = 3;",
                "constexpr int SUM_SLOTS = 6;")],
    "warps4": [("constexpr int SUM_WARPS = 8;",
                "constexpr int SUM_WARPS = 4;")],
    "diagnostic_stores": [("const int lo = splits[0], hi = splits[1];",
                           "const int lo = 0, hi = 0;")],
    "diagnostic_range": [("for (int c0 = lo; c0 < hi; c0 += 32) {",
                          "for (int c0 = lo; c0 < lo; c0 += 32) {")],
}


def k7sums_section(dev) -> tuple:
    """K7sums before its redesign against the committed kernel (with and
    without the plan's words), the cursor variant and the edits of
    ``K7SUMS_EDITS``, at edges 128 and 256 (module docstring).  Returns
    the rows and the kernels' registers."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from chip_smoke import NUM_NODES

    def variant(rel):
        with open(os.path.join(ROOT, "scripts", "variants", rel)) as f:
            return {rel: f.read()}, rel

    specs = {"k7sums_per_block": variant("att_sums_cta_per_block.cu"),
             "k7sums_cursor": variant("att_sums_cursor.cu")}
    for name, edits in K7SUMS_EDITS.items():
        specs[f"k7sums_{name}"] = ({
            "att_bsr.cu": edited(read("att_bsr.cu"), edits),
            "tf32x3.cuh": read("tf32x3.cuh"),
            "tile_sparse.cuh": read("tile_sparse.cuh")}, "att_bsr.cu")
    libs = build_libraries(specs)
    old = c_function(libs["k7sums_per_block"], "fitgnn_att_sums_per_block",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 2
                     + [ctypes.c_void_p])
    fns = {"cursor": c_function(libs["k7sums_cursor"],
                                "fitgnn_att_sums_cursor",
                                att_bsr._SUMS_ARGTYPES)}
    fns.update({name: c_function(libs[f"k7sums_{name}"], "fitgnn_att_sums",
                                 att_bsr._SUMS_ARGTYPES)
                for name in K7SUMS_EDITS})
    kernels.build([t for t in kernels.TARGETS if t.name == "att_bsr"])
    regs = {}
    logs = {"kept": next(t.log_path for t in kernels.TARGETS
                         if t.name == "att_bsr")}
    logs.update({name: os.path.join(OUT, name, f"lib{name}.log")
                 for name in specs})
    for form, log in logs.items():
        for k, n, spill in ptxas_entries(log):
            if k.startswith("att_sums_kernel"):
                regs[f"{form}: {k}"] = (n, spill)
    x, s, r, y, train = make_graph()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GATConv", seed=0)
    h256 = build_hybrid(g.senders.numpy().astype("int64"),
                        g.receivers.numpy().astype("int64"),
                        (g.edge_weight.numpy() > 0).astype("float32"),
                        g.num_nodes_padded, block=256, min_block_edges=48,
                        use_segmm=True, semantics="att_unit",
                        real_nodes=NUM_NODES)
    n = g.num_nodes_padded
    gen = torch.Generator(device=dev).manual_seed(25)
    stream = kernels.stream(dev)
    p = kernels.ptr
    results = []
    for edge, h in ((128, g.aux), (256, h256)):
        hd = h.to(dev)
        b, plan = hd.bsr, hd.dyn_plan
        nowords = dataclasses.replace(plan, words=None, t_words=None,
                                      live=None)
        slots = plan.t_row_splits.diff()
        print(f"K7sums@{edge}: {plan.row_splits.numel() - 1} block rows, "
              f"{slots.float().mean():.3f} slots a block on average, "
              f"{int(slots.max())} at most")
        ssrc, sdst, dden = (torch.randn(n, generator=gen, device=dev)
                            for _ in range(3))
        mg = (sdst + ssrc.max()).clamp_min(0.0)
        xx, gr = (torch.randn((n, 128), generator=gen, device=dev)
                  for _ in range(2))
        part = att_bsr._launch_scores("k7s", dev, b.blocks, b.rows, b.cols,
                                      plan.live, ssrc, sdst, mg, gr, xx,
                                      dden, 0.2)
        nb = plan.row_splits.numel() - 1
        words = plan.words is not None

        def launch(fn, *args):
            def run():
                dssrc, dsdst = torch.empty((2, n), device=dev)
                kernels.check(fn(p(part[0]), p(part[1]), p(plan.row_splits),
                                 p(plan.t_row_splits), p(plan.t_sel),
                                 p(plan.t_scale), *args, p(dssrc), p(dsdst),
                                 nb, edge, stream), "k7sums variant")
                return dssrc, dsdst
            return run

        with_words = ((p(plan.words), p(plan.t_words)) if words
                      else (None, None))
        forms = {"old": launch(old),
                 "words": lambda: att_bsr.att_sums(plan, *part),
                 "nowords": lambda: att_bsr.att_sums(nowords, *part),
                 **{name: launch(fn, *with_words)
                    for name, fn in fns.items()}}
        ref = forms["old"]()
        check(f"K7sums@{edge} words dssrc", forms["words"]()[0],
              att_bsr.att_sums_plain(plan, *part)[0])
        for f, run in forms.items():
            if f != "old" and not f.startswith("diagnostic") and not all(
                    torch.equal(a, c) for a, c in zip(run(), ref)):
                raise RuntimeError(f"K7sums@{edge} {f}: not the kernel "
                                   "before the redesign bit for bit")
        times = {f: [] for f in forms}
        for f in list(forms) + list(forms)[::-1]:
            times[f].append(device_ms(forms[f], 100))
        results.append({"kernel": f"K7sums@{edge}", "words": words,
                        **{f"{f}_ms": sum(v) / len(v)
                           for f, v in times.items()}, "runs_ms": times})
        print(results[-1])
        del hd, part
        torch.cuda.empty_cache()
    return results, regs


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
            ("  const int64_t k = QUAD ? id / (nq * nq) : id;\n",
             "  const int64_t r = blockIdx.x;\n  float rs0 = 0.f, rs1 = 0.f;\n"
             "  for (int64_t k = rows[r]; k < rows[r + 1]; ++k) {\n"),
            ("  const int64_t r = QUAD ? static_cast<int64_t>(rows[k]) * nq + qi"
             " : rows[k];\n", ""),
            ("  float rs0 = 0.f, rs1 = 0.f;\n#pragma unroll\n", "#pragma unroll\n"),
            ("""  if ((lane & 3) == 0) {
    rpart[rp * BLK + i0] = rs0;
    rpart[rp * BLK + i0 + 8] = rs1;
  }
""", ""),
            ("  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);\n"
             "  rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);\n"
             "  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);\n"
             "  rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);\n", ""),
            ("    cpart[cp * BLK + tid] = v;\n  }\n}\n",
             """    cpart[cp * BLK + tid] = v;
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
  for (int u = 0; u < SC_TILE / PER / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / PER);
    sparse::cp_async16(
        reinterpret_cast<float*>(tt + i * BLK
                                 + PER * ((q % (BLK / PER)) ^ (i & 7))),
        reinterpret_cast<const float*>(
            QUAD ? tile + i * edge + PER * (q % (BLK / PER)) : tile + PER * q),
        16);
  }
""", ""),
            ("    const int at = i0 * BLK + PER * ((col / PER) ^ key) + (col % PER);\n"
             "    const float2 k0 = mask_pair(tt + at);\n"
             "    const float2 k1 = mask_pair(tt + at + 8 * BLK);",
             "    const int at = i0 * BLK + col;\n"
             "    const float2 k0 = mask_pair(tile + at);\n"
             "    const float2 k1 = mask_pair(tile + at + 8 * BLK);")]),
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
  for (int u = 0; u < SC_TILE / PER / THREADS; ++u) {
    const int q = tid + THREADS * u;
    const int i = q / (BLK / PER);
    sparse::cp_async16(
        reinterpret_cast<float*>(tt + i * BLK
                                 + PER * ((q % (BLK / PER)) ^ (i & 7))),
        reinterpret_cast<const float*>(
            QUAD ? tile + i * edge + PER * (q % (BLK / PER)) : tile + PER * q),
        16);
  }
"""


def k7_diagnostic(name: str):
    """Timing only (wrong results): ``no_epilogue`` keeps the pass's copies
    and product and sums the accumulators into one store; ``copy_late``
    starts the tile's copy after the product instead of before it."""
    src = read("att_bsr.cu")
    if name == "no_epilogue":
        a = src.index("  // the accumulator's rows i0 and i0 + 8")
        b = src.index("    cpart[cp * BLK + tid] = v;\n  }\n}\n")
        src = (src[:a] + "  float v = 0.f;\n#pragma unroll\n"
               "  for (int j = 0; j < 64; ++j) v += d[j];\n"
               "  cpart[k * BLK + (tid & 127)] = v;\n  rpart[k] = ts[tid];\n}\n"
               + src[b + len("    cpart[cp * BLK + tid] = v;\n  }\n}\n"):])
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


# the walk of the live quadrants with the vote kept and the slab copy
# after it, one slab buffer (the committed walk_live starts the next live
# quadrant's slab copy with its tile read, double-buffered)
SKIP_ONLY = [('''  if (m0 != 0) {
    const int q = __ffs(m0) - 1;
    val.stage(hs, 0, static_cast<int64_t>(col0) * nq + q, tid);
    slab(xs[0], q);
    fetch(q);
  }
  // the current quadrant is in ch, its slab copy in flight into xs[buf]
  for (int buf = 0; m0 != 0; buf ^= 1) {
    // the last apply is done: the tile and slab buf ^ 1 may be overwritten
    __syncthreads();
    ch.store(as, warp, lane);
    m0 &= m0 - 1;
    seek();
    if (m0 != 0) {
      // the next live quadrant's slab (with the hook's operand) and tile,
      // in flight during the apply
      const int q = __ffs(m0) - 1;
      val.stage(hs, buf ^ 1, static_cast<int64_t>(col0) * nq + q, tid);
      slab(xs[buf ^ 1], q);
      fetch(q);
    } else {
      cp_async_commit();                        // an empty group
    }
    cp_async_wait<1>();                         // slab buf has landed
''', '''  if (m0 != 0) fetch(__ffs(m0) - 1);
  for (const int buf = 0; m0 != 0;) {
    const bool any = __syncthreads_or(ch.any());
    if (any) {
      ch.store(as, warp, lane);
      val.stage(hs, buf, static_cast<int64_t>(col0) * nq + __ffs(m0) - 1,
                tid);
      slab(xs[buf], __ffs(m0) - 1);
    }
    m0 &= m0 - 1;
    seek();
    if (m0 != 0) fetch(__ffs(m0) - 1);
    if (!any) continue;
    cp_async_wait<0>();
''')]

# the committed words walk with the bf16 slab rounded one value a
# conversion, as the walks without words round it
ROUND_SINGLE = [("    if (ROUND_X) round_slab_pairs<VEC>(xs[buf], tid);",
                 "    if (ROUND_X) round_slab<VEC>(xs[buf], tid);")]

# the C entries of the words section: (wrapper ID, entry, argtypes, init)
QUAD_ENTRIES = (("K1", "fitgnn_bsr_spmm_acc", "_ARGS_ACC", True),
                ("K2", "fitgnn_bsr_spmm", "_ARGS_FWD", False),
                ("K9", "fitgnn_bsr_spmm_grouped", "_ARGS_FWD", False))


def quadwords_section(dev) -> tuple:
    """The walk with occupancy words, committed against skip only, null
    words and (bf16) the slab rounded singly (the module docstring says
    which); returns the rows and the words forms' registers."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops import bsr_spmm as bsr

    libs = build_libraries({name: ({
        "tile_sparse.cuh": edited(read("tile_sparse.cuh"), edits),
        "bsr_spmm.cu": read("bsr_spmm.cu")}, "bsr_spmm.cu")
        for name, edits in (("quad_skip_only", SKIP_ONLY),
                            ("quad_round_single", ROUND_SINGLE))})
    kernels.build([t for t in kernels.TARGETS if t.name == "bsr_spmm"])
    regs = {}
    for form, log in (("skip only", os.path.join(
            OUT, "quad_skip_only", "libquad_skip_only.log")),
            ("bf16 slab rounded singly", os.path.join(
                OUT, "quad_round_single", "libquad_round_single.log")),
            ("skip + early slab", next(t.log_path for t in kernels.TARGETS
                                       if t.name == "bsr_spmm"))):
        # the words forms: WORDS and QUAD, the two flags before the
        # activations' type
        for k, n, spill in ptxas_entries(log):
            if "walk_kernel" in k and k.replace(" ", "").endswith(
                    "true,true,float>"):
                regs[f"{form}: {k}"] = (n, spill)
    x, s, r, y, train = make_graph()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GCNConv", seed=0)
    ops = {k: h for k, h in block_operators(g).items()
           if k in ("t48", "group2")}
    n = g.num_nodes_padded
    del g
    gen = torch.Generator(device=dev).manual_seed(21)
    stream = kernels.stream(dev)
    results = []
    for tt in ("f32", "bf16"):
        for name, h in ops.items():
            b = (bf16_tiles(h) if tt == "bf16" else h).bsr.to(dev)
            for k, entry, args, with_init in QUAD_ENTRIES:
                if (k == "K9") != (name == "group2"):
                    continue
                fns = {f: c_function(libs[lib], kernels.entry(entry,
                                                              b.blocks),
                                     getattr(bsr, args))
                       for f, lib in (("skip", "quad_skip_only"),
                                      ("single", "quad_round_single"))}
                wrapper = {"K1": bsr.bsr_spmm_acc, "K2": bsr.bsr_spmm_fwd,
                           "K9": bsr.bsr_spmm_grouped}[k]
                nowords = dataclasses.replace(b, words=False)
                for feat in (128, 512):
                    xx = torch.randn((n, feat), generator=gen, device=dev)
                    ins = [xx]
                    if with_init:
                        ins.append(torch.randn((n, feat), generator=gen,
                                               device=dev))

                    def variant(f):
                        def run():
                            out = torch.empty_like(xx)
                            kernels.check(fns[f](
                                kernels.ptr(b.blocks),
                                kernels.ptr(b.row_splits),
                                kernels.ptr(b.cols), kernels.ptr(b.quad_bits),
                                *(kernels.ptr(t) for t in ins),
                                kernels.ptr(out), b.num_row_blocks, feat,
                                b.block, stream), f"{k} {f}")
                            return out
                        return run

                    forms = {"none": lambda: wrapper(nowords, *ins),
                             "skip": variant("skip"),
                             "early": lambda: wrapper(b, *ins)}
                    if tt == "bf16":
                        forms["single"] = variant("single")
                    plain = (bsr.bsr_spmm_acc_plain(b, *ins) if with_init
                             else bsr.bsr_spmm_plain(b, *ins))
                    got = {f: run() for f, run in forms.items()}
                    for f, out in got.items():
                        check(f"{k}@256 {tt} F={feat} {f}", out, plain)
                        if not torch.equal(out, got["none"]):
                            raise RuntimeError(f"{k}@256 {tt} F={feat} {f}:"
                                               " not the walk without words "
                                               "bit for bit")
                    times = {f: [] for f in forms}
                    order = ("none", "skip", "early", "single")
                    for f in order + order[::-1]:
                        if f in forms:
                            times[f].append(ms(forms[f]))
                    results.append({
                        "kernel": f"{k}@256", "tiles": tt, "operator": name,
                        "F": feat, **{f"{f}_ms": sum(v) / len(v)
                                      for f, v in times.items()},
                        "runs_ms": times})
                    print(results[-1])
                    del xx, ins, got, plain
            del b, nowords
            torch.cuda.empty_cache()
    return results, regs


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
    if "--quad-words-only" in sys.argv[1:]:
        rows, regs = quadwords_section(dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "registers": regs, "results": rows}))
        return 0
    if "--k7sums-only" in sys.argv[1:]:
        rows, regs = k7sums_section(dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "registers": regs, "results": rows}))
        return 0
    if "--k5-live-only" in sys.argv[1:]:
        rows, regs = k5_live_section(dev)
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "registers": regs, "results": rows}))
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
                               128, int(trans), kernels.stream(dev)),
                          "k8_late")
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
                                None, kernels.ptr(gr), kernels.ptr(x),
                                kernels.ptr(out), TILES, 0, feat, 128,
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
                             p(cols), null, p(ssrc), p(sdst), p(mg), p(x),
                             p(out), p(den), NB, feat, 128, 0, 0.2, stream),
                          "k7 fwd")
            return out, den

        def dx(fn):
            out = torch.empty_like(x)
            kernels.check(fn(p(blocks), p(plan.t_row_splits), p(plan.t_sel),
                             p(plan.t_scale), p(plan.t_cols), null, p(ssrc),
                             p(sdst), p(mg), p(x), p(out), null, NB, feat,
                             128, 1, 0.2, stream), "k7 dx")
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
                                          rows, cols, None, ssrc, sdst, mg,
                                          gr, x, dden, 0.2)

        def run_tiles(fn, what):
            def run():
                cp, rp = torch.empty((2, TILES, 128), device=dev)
                kernels.check(fn(p(blocks), p(rows), p(cols), null,
                                 p(ssrc), p(sdst), p(mg), p(dden), p(gr),
                                 p(x), p(cp), p(rp), TILES, 0, feat, 128,
                                 0.2, stream),
                              what)
                return cp, rp
            return run

        def scores_per_row():
            cp = torch.empty((TILES, 128), device=dev)
            dsdst = torch.empty(NB * 128, device=dev)
            kernels.check(per_row(p(blocks), p(plan.row_splits), p(cols),
                                  null, p(ssrc), p(sdst), p(mg), p(dden),
                                  p(gr), p(x), p(cp), p(dsdst), NB, 0, feat,
                                  128, 0.2, stream), "k7 per row")
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
    rows, quad_regs = quadwords_section(dev)
    results.extend(rows)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "registers": {**regs, **quad_regs},
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
