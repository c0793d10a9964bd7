#!/usr/bin/env python3
"""Design choices of K8, K5 and K7's walks, each against its alternative,
on one GPU.

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

Each alternative is the committed source with a few textual edits, built
with ``nvcc`` into ``build/fitgnn_tpu_torch/variants/``; the script fails
if an edit no longer applies.  Inputs are synthetic at the bench graph's
shapes, made on the card from seed 0: 1,324 diagonal blocks of 4.5% fill
(one empty) with ``init``, at F = 128, 512 and 512 transposed; 2,192 tile
pairs sorted by block row over 1,324 block rows at F = 128, 512 and 101
(K5), and as presence tiles of 3.04% fill with unit-normal scores at F =
128 and 512 (K7).
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

from chip_smoke import ptxas_entries  # noqa
from fitgnn_tpu_torch.ops import (att_bsr, bsr_dynamic, diag_spmm,  # noqa
                                  kernels)
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


def build_variant(name: str, files: dict, main: str, fn: str, argtypes):
    """Writes ``files`` (name -> text) into a directory of their own,
    compiles ``main`` and returns its C function ``fn``."""
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f, text in files.items():
        with open(os.path.join(d, f), "w") as fh:
            fh.write(text)
    lib = os.path.join(d, f"lib{name}.so")
    out = subprocess.run([kernels.nvcc(), *kernels.NVCC_FLAGS, "-o", lib,
                          os.path.join(d, main)], check=True,
                         capture_output=True, text=True)
    with open(os.path.join(d, f"lib{name}.log"), "w") as f:
        f.write(out.stdout + out.stderr)
    c = getattr(ctypes.CDLL(lib), fn)
    c.restype = ctypes.c_int
    c.argtypes = argtypes
    return c


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
    src = edited(read("bsr_dynamic.cu"), [
        ("    2 * STAGE * static_cast<int>(sizeof(float)) + 1024;",
         "    3 * STAGE * static_cast<int>(sizeof(float)) + 1024;"),
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
        "bsr_dynamic.cu": src, "tile_sparse.cuh": read("tile_sparse.cuh")},
        "bsr_dynamic.cu", "fitgnn_dyn_grad_blocks",
        bsr_dynamic._GRAD_ARGTYPES)


def k7_variant(name: str, edits: list):
    """K7's walk entry built with ``tile_sparse.cuh`` edited."""
    return build_variant(name, {
        "tile_sparse.cuh": edited(read("tile_sparse.cuh"), edits),
        "att_bsr.cu": read("att_bsr.cu")}, "att_bsr.cu", "fitgnn_att_walk",
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


def k7_registers(log: str) -> dict:
    return {k: (n, spill) for k, n, spill in ptxas_entries(log)
            if "Scores" in k}


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
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
    kept = kernels.function("att_bsr", "fitgnn_att_walk",
                            att_bsr._WALK_ARGTYPES)
    target = next(t for t in kernels.TARGETS if t.name == "att_bsr")
    regs = {"kept": k7_registers(target.log_path),
            "rows_early": k7_registers(os.path.join(
                OUT, "k7_rows_early", "libk7_rows_early.log")),
            "cols_late": k7_registers(os.path.join(
                OUT, "k7_cols_late", "libk7_cols_late.log"))}
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
                                       sdst, 0.2)[0]
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
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "registers": regs, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
