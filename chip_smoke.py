#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths (the full-graph
baselines and the FIT-GNN curriculum) on one GPU and hold its CUDA kernels
against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit; build every native library (one
   ``nvcc`` per CUDA source and the Leiden g++ build, all in parallel) and
   print each kernel's registers and spilled bytes from ``ptxas -v``;
2. the bench graph (seed 0, 169,344 nodes, 128 features, 40 classes, the
   generator of ``bench.py``), saved as an npz dataset in a temp root;
3. kernels, each against its plain version (rtol 1e-4, atol
   1e-4·max|ref|: f32 sums in another order), with kernel, plain and
   library times and the bound from bytes and operations: on the GCN
   operator K1 (``bsr_spmm_acc``) and K3 (``segmm_spmm``) at F=128 and
   512, and the hybrid SpMM on a small graph against a dense float64
   product; on the GAT (``att_unit``) operator, whose tile split must equal
   the GCN operator's, K4 (``dyn_tiles``) and K4ᵀ (``dyn_tiles_t``) at
   F=128 and 512, K5 (``dyn_grad_blocks``, bound at the tensor cores' TF32
   rate for its three passes) at F=128 and 512 and K3w
   (``segmm_weighted_raw``) at F=40 (off the path) and 64, and on the
   transpose CSR at F=512 (K6's ``dx``, the permutation passed to the
   kernel); then the fused tile attention and K6 at F=128 and
   512: K7rm (``att_rowmax``), K7f (``att_fwd``), K7bt (``att_bwd_t``'s
   ``dx`` walk; the path launches it at F=512 only), K7s (the score pass of
   ``att_bwd_scores``: ``dsdst`` and ``dssrc``'s column partials, timed
   alone and with both outputs, beside ``torch.sparse.sampled_addmm`` for
   its ⟨g, x⟩ alone; two launches bit-equal; the longest block row's tile
   count printed), K7sums (``att_sums``, ``dssrc`` and ``dsdst`` from the
   partials) and K6
   (``segmm_weighted_den_raw``), each beside the two-stage path it
   replaces (materialised tile scores, K4/K4ᵀ/K5 and PyTorch's
   elementwise work, forward and autograd backward), whose outputs and
   gradients they must also match; then on the opt-in operators of the
   GCN graph (``use_diag`` and ``tile_group=2`` through
   ``build_optimized_graph``, ``use_rowwalk`` through ``build_hybrid``) K2
   (``bsr_spmm_fwd``), K9 (``bsr_spmm_grouped``) and K10
   (``bsr_spmm_rowwalk``) at F=128 and 512, K8 (``diag_spmm``) forward and
   transpose with and without ``init`` at F=128 and 512 (after the
   diagonal blocks' non-zero count and fill), and K11
   (``philox_dropout``) at (N_pad, 512), bit for bit.  The straggler
   sum's forms (K3, K3w, K6) are launched twice (bit-equal) and timed by
   their device time (``device_ms``: the kernel alone, which is all their
   wrappers launch) and with their wrappers' host work (``wrapper_ms``),
   each beside the launch shape it took (lanes a row, floats a lane,
   gathers in flight, rows a CTA);
4. gradients: one GAT and one GCN training step (hidden 512, dropout off,
   the same seed-0 init) with the kernels and then with the plain versions
   patched in; the loss and every parameter gradient within the tolerance
   above, and the launches of the kernel step: GAT K4 ×2, K4ᵀ ×1 (layer
   0's input, the raw features, needs no gradient), K5 ×2; GCN K1 ×3 and
   K3 ×3 (two forward, one backward for layer 1: layer 0 aggregates the
   raw features); then the GAT step under ``FITGNN_GAT_FUSED_TILES=1
   FITGNN_GAT_SEGMM_DEN=1``, with kernels, with plain versions, and held
   against the default step too: K7f ×2, K7s ×2 and K7sums ×2 (both score
   gradients in each layer), K7bt ×1 (``dx`` only in layer 1), K6 ×2, K3w
   ×1 (K6's ``dx`` in layer 1);
5. the opt-ins through the library surface, every counter at 0 just
   before each counted run: GCNConv at hidden 512 with
   ``fused_dropout=True, bit_dropout=False`` (dropout 0.5: K11 ×4 a
   step) on each opt-in operator, one step's loss, gradients and eval
   forward against the default operator's under the same seed (the same
   K11 masks), then 2 epochs (``gc_train_step`` + ``gc_eval_step``) with
   the walk ×3 a step and ×2 an eval (K8 and K1 / K9 / K10) and K3 alike;
   eval forwards on a forward-only operator (the BCSR without its
   transpose: K3 and K2 ×2 each) against the default forward, and
   ``spmm(operator=BsrMatrix)`` forward and backward (K2 ×2);
6. train: ``train --baseline`` through the port's CLI on ``cuda``, every
   launch counter at 0 just before each run: GATConv at hidden 512 for 3
   epochs, GCNConv at hidden 512 for 2 epochs, GATConv at hidden 64 for 1
   epoch (its aggregations are 64 wide, so K3w runs; the widths K3w
   launches at are tallied and must be 64 alone), GATConv at hidden
   512 for 2 epochs with ``FUSED_TILES=1 SEGMM_DEN=1`` and for 1 epoch
   with ``FUSED_TILES=1 GLOBAL_MAX=0`` (K7rm ×2 a forward); the launches
   against the counts per train step and eval forward that phase 4
   confirmed, a CSV row with finite losses and a checkpoint per run;
7. serve: ``infer-baseline`` for GATConv at hidden 512 from the checkpoint
   phase 6 saved (K4 ×2 per forward), the same with ``FUSED_TILES=1``
   from the fused run's checkpoint (K7f ×2 per forward), and for GCNConv
   at hidden 512 from random weights (K1 and K3 ×2 per forward), whose
   full forward with kernels is held against the same forward with the
   plain versions (atol 1e-4);
8. curriculum: the FIT-GNN curriculum through the port's CLI on ``cuda``
   at hidden 512, every launch counter at 0 just before each run
   (``CURRICULUM``): ``train`` GCNConv ``Gc_train_2_Gs_infer`` for 2
   epochs, whose partition (host seconds, metanodes, the subgraph batch's
   (S, N_pad, E_pad)) is computed once and then taken from the port's
   cache by every later run; ``Gc_train_2_Gs_train`` in GD and in MB
   (``--batch_size 128``) for 1 + 1 epochs; ``Gs_train_2_Gs_infer`` for 1;
   GATConv ``Gc_train_2_Gs_infer`` for 1.  Each Gc run prints Gc's tiles
   and stragglers and launches the counts per train step and eval forward
   that phase 4 confirmed times its epochs; the Gs epochs and evals launch
   none.  Then ``infer`` from the first run's checkpoint (64 samples, no
   launches), printed beside phase 7's GCN ``infer-baseline`` row, and
   the batched Gs eval forward of the first 4,096 subgraphs on the card
   against the same forward on the CPU (GCN and GAT, tolerance as in
   phase 3);
9. one JSON line with every kernel's numbers (launches summed over the
   main-path phases 5 to 8, per phase beside them; K3, K3w, K6, K5,
   K7f, K7bt, K7s and K7sums with their ``ptxas`` register and spill
   counts), then the ``ok`` line.

The JAX package's environment switches are set in ``os.environ`` for one
phase and restored after it; the earlier phases must launch none of K6
and K7, and the CLI phases none of the opt-in kernels.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12        # f32 outside the tensor cores
PEAK_TF32_FLOP_PER_S = 495e12      # TF32 on the tensor cores

# bench.py's graph
NUM_NODES = 169_344
COMM = 128
AVG_DEGREE = 7
NUM_FEATURES = 128
NUM_CLASSES = 40
INTERNAL = 0.85
HIDDEN = 512

# the JAX package's ingest of this graph on the TPU (BENCH_r05.json)
REF_TILES = 2_192
REF_STRAGGLERS = 232_718

RTOL = 1e-4
SLOPE = 0.2                        # GATConv's LeakyReLU slope

# the JAX package's tile_gat switches of the fused phases
FUSED = {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_SEGMM_DEN": "1"}
FUSED_EXACT = {"FITGNN_GAT_FUSED_TILES": "1", "FITGNN_GAT_GLOBAL_MAX": "0"}
FUSED_ONLY = {"FITGNN_GAT_FUSED_TILES": "1"}


def make_graph():
    """bench.py's community graph generator (seed 0)."""
    rng = np.random.default_rng(0)
    e = NUM_NODES * AVG_DEGREE // 2
    receivers = rng.integers(0, NUM_NODES, e, dtype=np.int64)
    comm = receivers // COMM
    s_in = comm * COMM + rng.integers(0, COMM, e)
    s_out = rng.integers(0, NUM_NODES, e)
    senders = np.where(rng.random(e) < INTERNAL, s_in, s_out)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    perm = rng.permutation(NUM_NODES)
    senders, receivers = perm[senders], perm[receivers]
    x = rng.standard_normal((NUM_NODES, NUM_FEATURES)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, NUM_NODES).astype(np.int32)
    train = rng.random(NUM_NODES) < 0.5
    return x, senders, receivers, y, train


def walk_args(kernel_name: str):
    """(TRANS, INIT, DIAG, hook) of a ``sparse::walk_kernel<TRANS, INIT,
    VEC, DIAG, V>`` launch by its demangled name, ``hook`` the value
    hook's name without its namespace ("Plain", K7f's "FwdScores", K7bt's
    "DxScores"), or None for any other kernel (the profile scripts group
    the walk's users by these)."""
    m = re.search(r"sparse::walk_kernel<(\w+),(\w+),(\w+),(\w+),"
                  r"(?:\w+::)*(\w+)>", kernel_name.replace(" ", ""))
    if m is None:
        return None
    trans, init, _, diag = (v in ("true", "1") for v in m.groups()[:4])
    return trans, init, diag, m.group(5)


class Failed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise Failed(msg)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 2) -> float:
    """``cuda_ms`` with the stream held busy (``torch.cuda._sleep``) while
    the host enqueues the launches, so that the wrapper's host time between
    two launches does not count: the device time of a kernel shorter than
    its wrapper's host work."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def segmm_times(fn) -> dict:
    """The straggler sum's times (K3, K3w, K6): ``ms`` its device time
    (the kernel alone: its wrapper launches nothing else) and
    ``wrapper_ms`` with the wrapper's host work."""
    return {"ms": device_ms(fn, 20), "wrapper_ms": cuda_ms(fn, 20)}


def segmm_note(sh: dict) -> str:
    from fitgnn_tpu_torch.ops.coo_segmm import launch_shape
    return (f" wrapper_ms={sh['wrapper_ms']:.4f} launch shape "
            f"{launch_shape(sh['F'])}")


def compare(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    scale = float(ref.abs().max())
    atol = 1e-4 * scale
    max_abs = float(diff.max())
    max_rel = float((diff / ref.abs().clamp_min(atol if atol > 0 else 1e-30)
                     ).max())
    ok = bool((diff <= atol + RTOL * ref.abs()).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"(atol={atol:.3e}, rtol={RTOL})")
    check(ok, f"{name}: kernel disagrees with its plain version")
    return {"max_abs_err": max_abs, "max_rel_err": max_rel}


@contextlib.contextmanager
def switches(env: dict):
    """Set the JAX package's switches for one phase, restore after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bound(bytes_: float, ops: float,
          flop_per_s: float = PEAK_F32_FLOP_PER_S) -> tuple:
    """The least time in ms for ``bytes_`` over the memory rate and ``ops``
    over ``flop_per_s`` (the unit the kernel computes in), the larger of
    the two, and which it is."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_entries(log_path: str) -> list:
    """(kernel, registers, spilled bytes) of each entry function in a
    ``ptxas -v`` log; names demangled by ``c++filt`` where it is found,
    without their parameter lists."""
    found, name, spill = [], None, 0
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name, spill = m.group(1), 0
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and name:
                spill = int(m.group(1)) + int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                found.append([name, int(m.group(1)), spill])
                name = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(
            e[0] for e in found), capture_output=True, text=True,
            check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        names = [e[0] for e in found]
    for e, n in zip(found, names):
        n = n.replace("(anonymous namespace)::", "")
        e[0] = re.sub(r"^void ", "", n.split("(")[0])
    return [tuple(e) for e in found]


def phase_build() -> list:
    """Builds every library; returns (library, kernel, registers, spilled
    bytes) of each kernel, which it prints."""
    from fitgnn_tpu_torch.ops import kernels
    from fitgnn_tpu_torch.partition.community import LEIDEN
    from fitgnn_tpu_torch.utils.build import build
    t0 = time.perf_counter()
    built = build([*kernels.TARGETS, LEIDEN])
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    regs = []
    for t in kernels.TARGETS:
        for kernel, n, spill in ptxas_entries(t.log_path):
            print(f"  {t.name}: {kernel}: {n} registers, {spill} bytes "
                  "spilled")
            regs.append((t.name, kernel, n, spill))
    return regs


def phase_small_reference(device) -> None:
    """Hybrid SpMM (K3 then K1) on a small community graph against a dense
    float64 product on the host."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid, hybrid_spmm
    rng = np.random.default_rng(1)
    n, e, f = 1024, 12_000, 128
    r = np.sort(rng.integers(0, n, e))
    s = np.where(rng.random(e) < 0.8, (r // 128) * 128
                 + rng.integers(0, 128, e), rng.integers(0, n, e))
    w = rng.random(e).astype(np.float32)
    h = build_hybrid(s, r, w, n, min_block_edges=48, use_segmm=True)
    check(h.bsr is not None and h.num_coo_edges > 1,
          "small reference graph must have tiles and stragglers")
    x = rng.standard_normal((n, f)).astype(np.float32)
    a = np.zeros((n, n))
    np.add.at(a, (r, s), w.astype(np.float64))
    ref = torch.from_numpy((a @ x.astype(np.float64)).astype(np.float32))
    with torch.inference_mode():
        got = hybrid_spmm(h.to(device), torch.from_numpy(x).to(device)).cpu()
    compare("hybrid_spmm small graph vs dense float64", got, ref)


def tile_csr(b, n: int) -> tuple:
    """The CSR of a BCSR operator's tile non-zeros (the library yardstick's
    operand) and their count."""
    nz = b.blocks.nonzero()
    rows = b.rows.long()[nz[:, 0]] * 128 + nz[:, 1]
    cols = b.cols.long()[nz[:, 0]] * 128 + nz[:, 2]
    csr = torch.sparse_coo_tensor(
        torch.stack([rows, cols]), b.blocks[nz[:, 0], nz[:, 1], nz[:, 2]],
        (n, n)).coalesce().to_sparse_csr()
    return csr, nz.shape[0]


def phase_kernels(device, ds) -> tuple:
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc, bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm, segmm_spmm_plain

    t0 = time.perf_counter()
    g, order = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                     y=ds.y, train_mask=ds.train_mask,
                                     layer_name="GCNConv", seed=0)
    print(f"ingest (Leiden + hybrid build): {time.perf_counter() - t0:.1f} s")
    h = g.aux
    tiles_all = h.bsr.nnz_blocks
    nz_tile = (h.bsr.blocks.reshape(tiles_all, -1) != 0).any(dim=1)
    tiles = int(nz_tile.sum())
    stragglers = int((h.weights != 0).sum())
    tile_edges = int((h.bsr.blocks != 0).sum())
    print(f"edges: {int(g.n_edge)} (tile edges {tile_edges}, tile occupancy "
          f"{tile_edges / (tiles * 128 * 128):.4f})")
    print(f"hybrid: N_pad={g.num_nodes_padded} tiles={tiles} "
          f"(+{tiles_all - tiles} coverage fillers) stragglers={stragglers} "
          f"(reference ingest: {REF_TILES} tiles, {REF_STRAGGLERS} "
          f"stragglers; diff {tiles - REF_TILES:+d} / "
          f"{stragglers - REF_STRAGGLERS:+d})")

    gd = g.to(device)
    hd = gd.aux
    b, m = hd.bsr, hd.segmm
    n = g.num_nodes_padded
    gen = torch.Generator(device=device).manual_seed(0)

    # library yardsticks: the same products through torch.sparse (cuSPARSE)
    a_tiles, _ = tile_csr(b, n)
    a_str = torch.sparse_csr_tensor(m.row_ptr, m.senders, m.weights, (n, n))
    uniq_cols = int(torch.unique(b.cols[nz_tile.to(device)]).numel())
    uniq_senders = int(torch.unique(m.senders[m.weights != 0]).numel())
    e = stragglers

    shapes = {"K1": [], "K3": []}
    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x = (gd.x if feat == NUM_FEATURES else
                 torch.randn((n, feat), generator=gen, device=device))
            print(f"F={feat}:")
            init = segmm_spmm_plain(m, x)
            k3 = segmm_spmm(m, x)
            k3_again = segmm_spmm(m, x)
            torch.cuda.synchronize()
            err3 = compare(f"K3 segmm_spmm F={feat}", k3, init)
            check(torch.equal(k3, k3_again), f"K3 F={feat}: two launches "
                  "differ")
            del k3_again
            k1 = bsr_spmm_acc(b, x, init)
            p1 = bsr_spmm_acc_plain(b, x, init)
            torch.cuda.synchronize()
            err1 = compare(f"K1 bsr_spmm_acc F={feat}", k1, p1)
            # yardsticks: one PyTorch call each computing the same function
            def lib1():
                return torch.sparse.addmm(init, a_tiles, x)

            def lib3():
                return torch.sparse.mm(a_str, x)

            compare(f"K1 library torch.sparse.addmm F={feat}", lib1(), p1)
            compare(f"K3 library torch.sparse.mm F={feat}", lib3(), init)

            # K1's function needs 2 FLOPs per tile non-zero and feature,
            # which is what the kernel's walk of the non-zeros does
            b1, by1 = bound(
                tiles * 128 * 128 * 4 + (2 * tiles_all + b.num_row_blocks + 1)
                * 4 + uniq_cols * 128 * feat * 4 + 2 * n * feat * 4,
                2.0 * tile_edges * feat)
            b3, by3 = bound((n + 1) * 4 + e * 8 + uniq_senders * feat * 4
                            + n * feat * 4, 2.0 * e * feat)
            shapes["K1"].append(dict(
                F=feat, **err1, bound_ms=b1, bound_by=by1,
                ms=cuda_ms(lambda: bsr_spmm_acc(b, x, init), 20),
                plain_ms=cuda_ms(lambda: bsr_spmm_acc_plain(b, x, init), 5),
                library_ms=cuda_ms(lib1, 20)))
            shapes["K3"].append(dict(
                F=feat, **err3, bound_ms=b3, bound_by=by3,
                **segmm_times(lambda: segmm_spmm(m, x)),
                plain_ms=cuda_ms(lambda: segmm_spmm_plain(m, x), 20),
                library_ms=cuda_ms(lib3, 20)))
            for k in ("K1", "K3"):
                s = shapes[k][-1]
                print(f"  {k} F={feat}: kernel_ms={s['ms']:.4f} "
                      f"plain_ms={s['plain_ms']:.4f} "
                      f"library_ms={s['library_ms']:.4f} "
                      f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']})"
                      + (segmm_note(s) if k == "K3" else ""))
    return g, order, shapes


def counters() -> dict:
    """Every kernel wrapper of the path, by the ID of the TPU kernel it
    replaces; each counts its own launches."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import (dyn_grad_blocks,
                                                  dyn_tiles, dyn_tiles_t)
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc, bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.coo_segmm import (segmm_spmm,
                                                segmm_weighted_den_raw,
                                                segmm_weighted_raw)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm
    from fitgnn_tpu_torch.ops.dropout import philox_dropout
    return {"K1": bsr_spmm_acc, "K3": segmm_spmm, "K4": dyn_tiles,
            "K4T": dyn_tiles_t, "K5": dyn_grad_blocks,
            "K3w": segmm_weighted_raw, "K6": segmm_weighted_den_raw,
            "K7rm": att_bsr.att_rowmax, "K7f": att_bsr.att_fwd,
            "K7bt": att_bsr.att_bwd_t, "K7s": att_bsr.att_bwd_scores,
            "K7sums": att_bsr.att_sums,
            "K2": bsr_spmm_fwd, "K8": diag_spmm, "K9": bsr_spmm_grouped,
            "K10": bsr_spmm_rowwalk, "K11": philox_dropout}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def phase_gat_kernels(device, ds, g_gcn) -> tuple:
    """K4, K4ᵀ, K5 and K3w on the bench graph's att_unit operator."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.bsr_dynamic import (
        dyn_grad_blocks, dyn_grad_blocks_plain, dyn_tiles, dyn_tiles_plain,
        dyn_tiles_t, dyn_tiles_t_plain)
    from fitgnn_tpu_torch.ops.coo_segmm import (segmm_weighted_raw,
                                                segmm_weighted_raw_plain)

    t0 = time.perf_counter()
    g, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                 y=ds.y, train_mask=ds.train_mask,
                                 layer_name="GATConv", seed=0)
    print(f"GAT ingest (Leiden + hybrid build): "
          f"{time.perf_counter() - t0:.1f} s")
    h, hg = g.aux, g_gcn.aux
    check(h.semantics == "att_unit" and h.dyn_plan is not None,
          "GAT operator without a dynamic-tile plan")
    same = (torch.equal(h.bsr.rows, hg.bsr.rows)
            and torch.equal(h.bsr.cols, hg.bsr.cols)
            and torch.equal(h.bsr.blocks > 0, hg.bsr.blocks != 0)
            and torch.equal(h.senders, hg.senders)
            and torch.equal(h.receivers, hg.receivers))
    check(same, "att_unit tile split differs from the GCN operator's")
    print(f"att_unit operator: {h.bsr.nnz_blocks} tiles and "
          f"{int((h.weights > 0).sum())} stragglers, the same split as the "
          "GCN operator")

    gd = g.to(device)
    hd = gd.aux
    b, plan, m = hd.bsr, hd.dyn_plan, hd.segmm
    n = g.num_nodes_padded
    k_all = b.nnz_blocks
    gen = torch.Generator(device=device).manual_seed(1)
    mask = b.blocks > 0
    # attention-like tile values: positive on the adjacency, zero elsewhere
    blocks = torch.where(mask, torch.rand(mask.shape, generator=gen,
                                          device=device), 0.0)
    nnz = int(mask.sum())
    nz = mask.nonzero()
    a_rows = b.rows.long()[nz[:, 0]] * 128 + nz[:, 1]
    a_cols = b.cols.long()[nz[:, 0]] * 128 + nz[:, 2]
    a_vals = blocks[nz[:, 0], nz[:, 1], nz[:, 2]]
    a_csr = torch.sparse_coo_tensor(torch.stack([a_rows, a_cols]), a_vals,
                                    (n, n)).coalesce().to_sparse_csr()
    a_t_csr = torch.sparse_coo_tensor(torch.stack([a_cols, a_rows]), a_vals,
                                      (n, n)).coalesce().to_sparse_csr()
    uniq_cols = int(torch.unique(b.cols).numel())
    uniq_rows = int(torch.unique(b.rows).numel())
    e = m.senders.shape[0]
    w_edge = torch.rand(e, generator=gen, device=device)
    str_csr = torch.sparse_csr_tensor(m.row_ptr, m.senders,
                                      w_edge * m.weights, (n, n))
    uniq_senders = int(torch.unique(m.senders[m.weights != 0]).numel())
    idx_bytes = (2 * k_all + b.num_row_blocks + 1) * 4

    shapes = {"K4": [], "K4T": [], "K5": [], "K3w": []}
    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x = torch.randn((n, feat), generator=gen, device=device)
            gr = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            k4 = dyn_tiles(b.rows, b.cols, plan, blocks, x)
            p4 = dyn_tiles_plain(b.rows, b.cols, plan, blocks, x)
            k4t = dyn_tiles_t(plan, blocks, gr)
            p4t = dyn_tiles_t_plain(plan, blocks, gr)
            k5 = dyn_grad_blocks(b.rows, b.cols, gr, x)
            p5 = dyn_grad_blocks_plain(b.rows, b.cols, gr, x)
            torch.cuda.synchronize()
            err4 = compare(f"K4 dyn_tiles F={feat}", k4, p4)
            err4t = compare(f"K4T dyn_tiles_t F={feat}", k4t, p4t)
            err5 = compare(f"K5 dyn_grad_blocks F={feat}", k5, p5)
            compare(f"K4 library torch.sparse.mm F={feat}",
                    torch.sparse.mm(a_csr, x), p4)
            compare(f"K4T library torch.sparse.mm F={feat}",
                    torch.sparse.mm(a_t_csr, gr), p4t)
            del k5, p5
            # K4 and K4ᵀ read every tile, the slabs of the distinct input
            # blocks, and write the output once; the function needs 2 FLOPs
            # per tile non-zero and feature
            b4, by4 = bound(k_all * 128 * 128 * 4 + idx_bytes
                            + uniq_cols * 128 * feat * 4 + n * feat * 4,
                            2.0 * nnz * feat)
            b4t, by4t = bound(k_all * 128 * 128 * 4 + 3 * plan.t_sel.numel()
                              * 4 + uniq_rows * 128 * feat * 4
                              + n * feat * 4, 2.0 * nnz * feat)
            # K5's output is every dense tile: 2·F FLOPs per entry, which
            # the kernel computes as three TF32 passes on the tensor cores
            # (hi/lo split); the same FLOPs on the f32 CUDA cores are kept
            # beside it
            b5_bytes = (k_all * 128 * 128 * 4 + idx_bytes
                        + (uniq_rows + uniq_cols) * 128 * feat * 4)
            b5_flops = 2.0 * k_all * 128 * 128 * feat
            b5, by5 = bound(b5_bytes, 3 * b5_flops, PEAK_TF32_FLOP_PER_S)
            b5_cc, _ = bound(b5_bytes, b5_flops)
            # one PyTorch call computes K5 only on slabs gathered first;
            # that bmm is timed (gather excluded) and labelled, not used
            # as library_ms
            gs = gr.reshape(-1, 128, feat).index_select(0, b.rows.long())
            xs = x.reshape(-1, 128, feat).index_select(0, b.cols.long())
            shapes["K4"].append(dict(
                F=feat, **err4, bound_ms=b4, bound_by=by4,
                ms=cuda_ms(lambda: dyn_tiles(b.rows, b.cols, plan, blocks,
                                             x), 20),
                plain_ms=cuda_ms(lambda: dyn_tiles_plain(
                    b.rows, b.cols, plan, blocks, x), 5),
                library_ms=cuda_ms(lambda: torch.sparse.mm(a_csr, x), 20)))
            shapes["K4T"].append(dict(
                F=feat, **err4t, bound_ms=b4t, bound_by=by4t,
                ms=cuda_ms(lambda: dyn_tiles_t(plan, blocks, gr), 20),
                plain_ms=cuda_ms(lambda: dyn_tiles_t_plain(plan, blocks,
                                                           gr), 5),
                library_ms=cuda_ms(lambda: torch.sparse.mm(a_t_csr, gr),
                                   20)))
            shapes["K5"].append(dict(
                F=feat, **err5, bound_ms=b5, bound_by=by5,
                bound_cuda_cores_ms=b5_cc,
                ms=cuda_ms(lambda: dyn_grad_blocks(b.rows, b.cols, gr, x),
                           10),
                plain_ms=cuda_ms(lambda: dyn_grad_blocks_plain(
                    b.rows, b.cols, gr, x), 5),
                library_ms=None,
                bmm_pregathered_ms=cuda_ms(
                    lambda: torch.bmm(gs, xs.transpose(1, 2)), 10)))
            del gs, xs
            for k in ("K4", "K4T", "K5"):
                sh = shapes[k][-1]
                lib = sh["library_ms"]
                print(f"  {k} F={feat}: kernel_ms={sh['ms']:.4f} "
                      f"plain_ms={sh['plain_ms']:.4f} library_ms="
                      f"{'null' if lib is None else f'{lib:.4f}'} "
                      f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")
            print(f"  K5 F={feat}: torch.bmm on pre-gathered slabs "
                  f"{shapes['K5'][-1]['bmm_pregathered_ms']:.4f} ms; bound "
                  f"on the f32 CUDA cores {b5_cc:.4f} ms")
        for feat in (NUM_CLASSES, 64):
            x = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            k3w = segmm_weighted_raw(m, w_edge, x)
            k3w_again = segmm_weighted_raw(m, w_edge, x)
            p3w = segmm_weighted_raw_plain(m, w_edge, x)
            torch.cuda.synchronize()
            err3w = compare(f"K3w segmm_weighted_raw F={feat}", k3w, p3w)
            check(torch.equal(k3w, k3w_again), f"K3w F={feat}: two "
                  "launches differ")
            compare(f"K3w library torch.sparse.mm F={feat}",
                    torch.sparse.mm(str_csr, x), p3w)
            b3w, by3w = bound((n + 1) * 4 + e * 12 + uniq_senders * feat * 4
                              + n * feat * 4, 2.0 * e * feat)
            # the GAT step at hidden 64 aggregates at F=64 in both layers
            # (128 → 64, 64 → 64; the head is a separate linear layer):
            # F=40, the class count, is off the path (phase 6 checks it)
            shapes["K3w"].append(dict(
                F=feat, on_path=feat == 64, **err3w, bound_ms=b3w,
                bound_by=by3w,
                **segmm_times(lambda: segmm_weighted_raw(m, w_edge, x)),
                plain_ms=cuda_ms(lambda: segmm_weighted_raw_plain(
                    m, w_edge, x), 20),
                library_ms=cuda_ms(lambda: torch.sparse.mm(str_csr, x), 20)))
            sh = shapes["K3w"][-1]
            print(f"  K3w F={feat}: kernel_ms={sh['ms']:.4f} "
                  f"plain_ms={sh['plain_ms']:.4f} "
                  f"library_ms={sh['library_ms']:.4f} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})"
                  + segmm_note(sh))
    return g, shapes


def phase_fused_kernels(device, g) -> dict:
    """K6 and K7 on the bench graph's att_unit operator at F=128 and 512,
    each against its plain version and beside the two-stage path it
    replaces; K3w on the transpose CSR at F=512 (K6's dx)."""
    from fitgnn_tpu_torch.ops import att_bsr
    from fitgnn_tpu_torch.ops.coo_segmm import (
        segmm_weighted_den_raw, segmm_weighted_den_raw_plain,
        segmm_weighted_raw, segmm_weighted_raw_plain)
    from fitgnn_tpu_torch.ops.tile_gat import tiles_two_stage

    gd = g.to(device)
    hd = gd.aux
    b, plan, m, mt = hd.bsr, hd.dyn_plan, hd.segmm, hd.t_segmm
    rows, cols, blocks = b.rows, b.cols, b.blocks
    n = g.num_nodes_padded
    nb = n // 128
    k_all = b.nnz_blocks
    nnz = int((blocks != 0).sum())
    uniq_cols = int(torch.unique(cols).numel())
    uniq_rows = int(torch.unique(rows).numel())
    gen = torch.Generator(device=device).manual_seed(2)
    # unit-variance scores, as a GAT layer's projections give them, and the
    # fused default branch's stabilizer (the global bound)
    ssrc = torch.randn(n, generator=gen, device=device)
    sdst = torch.randn(n, generator=gen, device=device)
    dden = torch.randn(n, generator=gen, device=device)
    mg = (sdst + ssrc.max()).clamp_min(0.0)
    vec = n * 4
    tile_bytes = k_all * 128 * 128 * 4
    idx_f = (k_all + nb + 1) * 4                  # cols, row_splits
    idx_t = (3 * plan.t_sel.numel() + nb + 1) * 4  # t_sel/scale/cols, splits
    e = m.senders.shape[0]
    w_edge = torch.rand(e, generator=gen, device=device)
    str_csr = torch.sparse_csr_tensor(m.row_ptr, m.senders,
                                      w_edge * m.weights, (n, n))
    uniq_senders = int(torch.unique(m.senders[m.weights != 0]).numel())
    t_perm = hd.t_edge_perm
    wt = w_edge[t_perm.long()].contiguous()
    t_uniq = int(torch.unique(mt.senders[mt.weights != 0]).numel())
    shapes = {k: [] for k in ("K6", "K7rm", "K7f", "K7bt", "K7s", "K7sums",
                              "K3w")}
    fwd = (rows, cols, plan, blocks, ssrc, sdst)
    two_label = ("the two-stage autograd backward for dssrc, dsdst and dx "
                 "(K5, K4ᵀ, the elementwise chain): compare with K7bt + K7s "
                 "+ K7sums")
    two_scores_label = ("the two-stage autograd backward for dssrc and "
                        "dsdst (K5, the elementwise chain): compare with "
                        "K7s + K7sums")
    # the score pass walks one CTA per block row: its longest run of tiles
    runs = plan.row_splits[1:] - plan.row_splits[:-1]
    print(f"score pass: {nb} block rows, {k_all} tiles, the longest block "
          f"row {int(runs.max())} tiles, {int((runs == 0).sum())} without "
          "one")
    # ⟨g, x⟩ at the mask's entries through one PyTorch call (a reference
    # for that part of the pass alone; no one call gives d_raw's sums)
    nz = (blocks != 0).nonzero()
    m_rows = rows.long()[nz[:, 0]] * 128 + nz[:, 1]
    m_cols = cols.long()[nz[:, 0]] * 128 + nz[:, 2]
    mask_csr = torch.sparse_coo_tensor(
        torch.stack([m_rows, m_cols]), torch.ones(nnz, device=device),
        (n, n)).coalesce().to_sparse_csr()
    del nz

    def plain_dx(gr):
        """The dx half of att_bwd_t_plain (materialised pe, bmm, index_add_):
        the plain version of K7bt's walk alone."""
        pe = att_bsr._tile_pe(blocks.index_select(0, plan.t_sel.long()), ssrc,
                              sdst, mg, plan.t_cols, plan.t_rows, SLOPE)[2]
        sc = plan.t_scale.to(pe.dtype)[:, None, None]
        dx = torch.bmm(pe.transpose(1, 2), att_bsr._slabs(gr, plan.t_cols))
        return att_bsr._sum_by_block(sc * dx, plan.t_rows, nb)

    def show(k, last=1):
        for sh in shapes[k][-last:]:
            lib, two = sh["library_ms"], sh.get("two_stage_ms")
            part = f" ({sh['launch']})" if "launch" in sh else ""
            print(f"  {k}{part} F={sh['F']}: kernel_ms={sh['ms']:.4f} "
                  f"plain_ms={sh['plain_ms']:.4f} library_ms="
                  f"{'null' if lib is None else f'{lib:.4f}'} "
                  f"two_stage_ms={'null' if two is None else f'{two:.4f}'} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")

    with torch.inference_mode():
        # K7rm: F-independent, one launch per layer
        rm = att_bsr.att_rowmax(*fwd, SLOPE)
        rp = att_bsr.att_rowmax_plain(*fwd, SLOPE)
        torch.cuda.synchronize()
        has = rp > -1e29
        check(torch.equal(rm <= -1e29, ~has), "K7rm: rows without a tile "
              "entry differ from the plain version")
        err = compare("K7rm att_rowmax", rm[has], rp[has])
        brm, byrm = bound(tile_bytes + idx_f + 3 * vec, 3.0 * nnz)
        plain_rm = cuda_ms(lambda: att_bsr.att_rowmax_plain(*fwd, SLOPE), 5)
        shapes["K7rm"].append(dict(
            F=None, **err, bound_ms=brm, bound_by=byrm,
            ms=cuda_ms(lambda: att_bsr.att_rowmax(*fwd, SLOPE), 20),
            plain_ms=plain_rm, library_ms=None, two_stage_ms=plain_rm,
            two_stage_label="the materialised tile row max (its plain "
                            "version)"))
        show("K7rm")
    for feat in (NUM_FEATURES, HIDDEN):
        # at F=128 (layer 0, raw features) the backward needs no dx
        need_dx = feat == HIDDEN
        x = torch.randn((n, feat), generator=gen, device=device)
        gr = torch.randn((n, feat), generator=gen, device=device)
        bwd = (plan, blocks, ssrc, sdst, mg, gr, x, dden, SLOPE)
        print(f"F={feat}:")
        with torch.inference_mode():
            num, den = att_bsr.att_fwd(*fwd, mg, x, SLOPE)
            num_p, den_p = att_bsr.att_fwd_plain(*fwd, mg, x, SLOPE)
            dx = att_bsr.att_bwd_t(*bwd, need_dssrc=False)[0]
            dx_p, dss_p = att_bsr.att_bwd_t_plain(*bwd)
            dss, dsd = att_bsr.att_bwd_scores(rows, cols, *bwd)
            dss2, dsd2 = att_bsr.att_bwd_scores(rows, cols, *bwd)
            dsd_p = att_bsr.att_bwd_f_plain(rows, cols, *bwd)
            # the pass and the sums apart, each against its plain version
            # on the same inputs
            part = att_bsr._launch_scores("att_bwd_scores", device, blocks,
                                          rows, cols, ssrc, sdst, mg, gr, x,
                                          dden, SLOPE)
            part_p = att_bsr.att_scores_plain(rows, cols, *bwd)
            sums = att_bsr.att_sums(plan, *part_p)
            sums_p = att_bsr.att_sums_plain(plan, *part_p)
            # the entry points of the JAX package's two kernels
            dss_t = att_bsr.att_bwd_t(*bwd, need_dx=False)[1]
            dsd_f = att_bsr.att_bwd_f(rows, cols, *bwd)
            num6, den6 = segmm_weighted_den_raw(m, w_edge, x)
            num6_2, den6_2 = segmm_weighted_den_raw(m, w_edge, x)
            num6_p, den6_p = segmm_weighted_den_raw_plain(m, w_edge, x)
            torch.cuda.synchronize()
            e_f = [compare(f"K7f att_fwd {what} F={feat}", a, p_)
                   for what, a, p_ in (("num", num, num_p),
                                       ("den", den, den_p))]
            e_t = compare(f"K7bt att_bwd_t dx F={feat}", dx, dx_p)
            e_s = [compare(f"K7s att_bwd_scores {what} F={feat}", a, p_)
                   for what, a, p_ in (("dssrc", dss, dss_p),
                                       ("dsdst", dsd, dsd_p))]
            e_p = [compare(f"K7s pass {what} partials F={feat}", a, p_)
                   for what, a, p_ in zip(("column", "row"), part, part_p)]
            e_c = [compare(f"K7sums att_sums {what} F={feat}", a, p_)
                   for what, a, p_ in zip(("dssrc", "dsdst"), sums, sums_p)]
            compare(f"K7bt att_bwd_t dssrc F={feat}", dss_t, dss_p)
            compare(f"K7bf att_bwd_f dsdst F={feat}", dsd_f, dsd_p)
            check(torch.equal(dss, dss2) and torch.equal(dsd, dsd2),
                  f"K7s/K7sums F={feat}: two launches differ")
            print(f"  K7s/K7sums F={feat}: two launches bit-equal")
            del part_p, dss2, dsd2
            e_6 = [compare(f"K6 segmm_weighted_den_raw {what} F={feat}",
                           a, p_) for what, a, p_ in (("num", num6, num6_p),
                                                      ("den", den6, den6_p))]
            check(torch.equal(num6, num6_2) and torch.equal(den6, den6_2),
                  f"K6 F={feat}: two launches differ")
            del num6_2, den6_2
            compare(f"K6 library torch.sparse.mm (num only) F={feat}",
                    torch.sparse.mm(str_csr, x), num6_p)
        # the two-stage path (materialised pe, K4, row sums; its autograd
        # backward: K5, K4ᵀ and the elementwise chain) must agree
        ss_, sd_ = ssrc.clone().requires_grad_(), sdst.clone().requires_grad_()
        x_ = x.clone().requires_grad_(need_dx)
        num2, den2 = tiles_two_stage(SLOPE, rows, cols, plan, blocks, ss_,
                                     sd_, mg, x_)
        inputs = (ss_, sd_, x_) if need_dx else (ss_, sd_)
        grads2 = torch.autograd.grad((num2, den2), inputs, (gr, dden),
                                     retain_graph=True)
        compare(f"K7f num vs two-stage F={feat}", num, num2.detach())
        compare(f"K7f den vs two-stage F={feat}", den, den2.detach())
        compare(f"K7s dssrc vs two-stage F={feat}", dss, grads2[0])
        compare(f"K7s dsdst vs two-stage F={feat}", dsd, grads2[1])
        if need_dx:
            compare(f"K7bt dx vs two-stage F={feat}", dx, grads2[2])
        two_bwd = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), inputs, (gr, dden), retain_graph=True), 5)
        two_scores = cuda_ms(lambda: torch.autograd.grad(
            (num2, den2), (ss_, sd_), (gr, dden), retain_graph=True), 5)
        del num2, den2, grads2
        with torch.inference_mode():
            slabs = 128 * feat * 4
            # K7f: tiles once, the three score vectors, the slabs of the
            # distinct input blocks, num and den out; 2·F FLOPs per tile
            # non-zero for the product, 1 for den, ~4 for score, LeakyReLU,
            # subtract and exp
            bf, byf = bound(tile_bytes + idx_f + 3 * vec + uniq_cols * slabs
                            + n * feat * 4 + vec, nnz * (2.0 * feat + 5))
            # K7s, the pass: tiles, four vectors, the distinct g and x
            # slabs, the two (K, 128) partials out; 2·F FLOPs per
            # non-zero for the ⟨g, x⟩ of d_pe and ~8 for the score, its
            # gradient and the sums.  Its dense product (three TF32
            # passes on the tensor cores) is printed beside it.
            bs, bys = bound(tile_bytes + 2 * k_all * 4 + 4 * vec
                            + (uniq_rows + uniq_cols) * slabs
                            + 2 * k_all * 128 * 4, nnz * (2.0 * feat + 8))
            bs_tc = 3 * 2.0 * k_all * 128 * 128 * feat \
                / PEAK_TF32_FLOP_PER_S * 1e3
            # K7sums: the partials read once, both walks' indices, dssrc
            # and dsdst out; one add a partial
            bc, byc = bound(2 * k_all * 128 * 4 + idx_t + (nb + 1) * 4
                            + 2 * vec, 2 * k_all * 128.0)
            # K7bt's dx: tiles, the transpose plan, ssrc, sdst and m, the
            # slabs of the distinct g blocks (the forward row blocks), dx
            # out; 2·F FLOPs per non-zero for peᵀ @ g and ~5 for pe
            bdx, bydx = bound(tile_bytes + idx_t + 3 * vec
                              + uniq_rows * slabs + n * feat * 4,
                              nnz * (2.0 * feat + 5))
            b6, by6 = bound((n + 1) * 4 + e * 12 + uniq_senders * feat * 4
                            + n * feat * 4 + vec, (2.0 * feat + 1) * e)
            shapes["K7f"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_f),
                max_rel_err=max(er["max_rel_err"] for er in e_f),
                bound_ms=bf, bound_by=byf,
                ms=cuda_ms(lambda: att_bsr.att_fwd(*fwd, mg, x, SLOPE), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_fwd_plain(
                    *fwd, mg, x, SLOPE), 5), library_ms=None,
                two_stage_ms=cuda_ms(lambda: tiles_two_stage(
                    SLOPE, rows, cols, plan, blocks, ssrc, sdst, mg, x), 10),
                two_stage_label="materialised pe, K4 and the den row sums"))
            # K7bt's dx walk alone; the main path launches it at F=512
            # only (layer 1), so the F=128 row is off the path
            compare(f"K7bt dx plain half vs att_bwd_t_plain F={feat}",
                    plain_dx(gr), dx_p)
            shapes["K7bt"].append(dict(
                F=feat, launch="dx", on_path=need_dx, **e_t,
                bound_ms=bdx, bound_by=bydx,
                ms=cuda_ms(lambda: att_bsr._launch_walk(
                    "att_bwd_t (dx)", device, blocks, plan.t_row_splits,
                    plan.t_sel, plan.t_scale, plan.t_cols, ssrc, sdst, mg,
                    gr, None, True, SLOPE), 20),
                plain_ms=cuda_ms(lambda: plain_dx(gr), 5), library_ms=None,
                two_stage_ms=two_bwd if need_dx else None,
                two_stage_label=two_label))
            # K7s: the pass alone; K7sums: the sums alone; both outputs
            # through att_bwd_scores (the pass and the sums, what replaced
            # the two reductions) beside them
            xt = x.t().contiguous()
            sampled = torch.sparse.sampled_addmm(mask_csr, gr, xt, beta=0.0)
            pick = torch.arange(0, nnz, max(1, nnz // 4096), device=device)
            compare(f"K7s reference sampled_addmm ⟨g, x⟩ F={feat}",
                    sampled.values()[pick],
                    (gr[torch.bucketize(pick, sampled.crow_indices(),
                                        right=True) - 1]
                     * x[sampled.col_indices()[pick]]).sum(1))
            del sampled
            both_ms = cuda_ms(lambda: att_bsr.att_bwd_scores(
                rows, cols, *bwd), 20)
            both_dev = device_ms(lambda: att_bsr.att_bwd_scores(
                rows, cols, *bwd), 20)
            shapes["K7s"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"]
                                        for er in (*e_s, *e_p)),
                max_rel_err=max(er["max_rel_err"] for er in (*e_s, *e_p)),
                bound_ms=bs, bound_by=bys, bound_tensor_cores_ms=bs_tc,
                ms=cuda_ms(lambda: att_bsr._launch_scores(
                    "att_bwd_scores", device, blocks, rows, cols, ssrc, sdst,
                    mg, gr, x, dden, SLOPE), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_scores_plain(
                    rows, cols, *bwd), 5),
                library_ms=None,
                sampled_addmm_ms=cuda_ms(lambda: torch.sparse.sampled_addmm(
                    mask_csr, gr, xt, beta=0.0), 20),
                both_outputs_ms=both_ms, both_outputs_device_ms=both_dev,
                both_outputs_plain_ms=cuda_ms(
                    lambda: att_bsr.att_bwd_scores_plain(rows, cols, *bwd),
                    5),
                two_stage_ms=two_scores, two_stage_label=two_scores_label))
            # the sums take a few microseconds, under their wrapper's host
            # work: ms is the device time, wrapper_ms cuda_ms's
            shapes["K7sums"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_c),
                max_rel_err=max(er["max_rel_err"] for er in e_c),
                bound_ms=bc, bound_by=byc,
                ms=device_ms(lambda: att_bsr.att_sums(plan, *part), 20),
                wrapper_ms=cuda_ms(lambda: att_bsr.att_sums(plan, *part), 20),
                plain_ms=cuda_ms(lambda: att_bsr.att_sums_plain(
                    plan, *part), 20), library_ms=None,
                two_stage_ms=None, two_stage_label=two_scores_label))
            sh = shapes["K7s"][-1]
            print(f"  K7s+K7sums F={feat}: both outputs "
                  f"{sh['both_outputs_ms']:.4f} ms (device time "
                  f"{sh['both_outputs_device_ms']:.4f}; plain "
                  f"{sh['both_outputs_plain_ms']:.4f}); the pass's dense "
                  f"product at the TF32 rate {bs_tc:.4f} ms; "
                  f"torch.sparse.sampled_addmm (⟨g, x⟩ alone) "
                  f"{sh['sampled_addmm_ms']:.4f} ms")
            del xt, part
            shapes["K6"].append(dict(
                F=feat, max_abs_err=max(er["max_abs_err"] for er in e_6),
                max_rel_err=max(er["max_rel_err"] for er in e_6),
                bound_ms=b6, bound_by=by6,
                **segmm_times(lambda: segmm_weighted_den_raw(m, w_edge, x)),
                plain_ms=cuda_ms(lambda: segmm_weighted_den_raw_plain(
                    m, w_edge, x), 20),
                library_ms=cuda_ms(lambda: torch.sparse.mm(str_csr, x), 20),
                library_label="torch.sparse.mm with runtime weights: num "
                              "only"))
            for k in ("K7f", "K7bt", "K7s", "K7sums", "K6"):
                show(k)
            print("  K6" + segmm_note(shapes["K6"][-1]))
            if feat == HIDDEN:
                # K6's dx in layer 1: K3w on the transpose CSR, the weights
                # w_edge[t_edge_perm] formed inside the kernel
                k3w = segmm_weighted_raw(mt, w_edge, gr, t_perm)
                k3w_again = segmm_weighted_raw(mt, w_edge, gr, t_perm)
                p3w = segmm_weighted_raw_plain(mt, w_edge, gr, t_perm)
                torch.cuda.synchronize()
                err3w = compare(f"K3w transpose CSR F={feat}", k3w, p3w)
                check(torch.equal(k3w, k3w_again), f"K3w transpose F={feat}:"
                      " two launches differ")
                del k3w_again
                t_csr = torch.sparse_csr_tensor(mt.row_ptr, mt.senders,
                                                wt * mt.weights, (n, n))
                # the CSR, senders, static weights, w_edge and perm once
                b3w, by3w = bound((n + 1) * 4 + e * 16 + t_uniq * feat * 4
                                  + n * feat * 4, 2.0 * e * feat)
                shapes["K3w"].append(dict(
                    F=feat, transpose=True, **err3w, bound_ms=b3w,
                    bound_by=by3w,
                    **segmm_times(lambda: segmm_weighted_raw(
                        mt, w_edge, gr, t_perm)),
                    plain_ms=cuda_ms(lambda: segmm_weighted_raw_plain(
                        mt, w_edge, gr, t_perm), 20),
                    library_ms=cuda_ms(lambda: torch.sparse.mm(t_csr, gr),
                                       20)))
                show("K3w")
                print("  K3w" + segmm_note(shapes["K3w"][-1]))
        del x, gr, x_, ss_, sd_
        torch.cuda.empty_cache()
    return shapes


def optin_operators(ds, g) -> dict:
    """The bench graph's GCN operator under each opt-in, on the node order
    of ``g``: ``use_diag`` and ``tile_group=2`` through
    ``build_optimized_graph``, the row walk through ``build_hybrid`` on the
    reordered graph (``build_optimized_graph`` has no ``use_rowwalk``, nor
    has the JAX one; ``bench.py`` builds it so)."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    ops = {}
    t0 = time.perf_counter()
    for name, kw in (("diag", dict(use_diag=True)),
                     ("group2", dict(tile_group=2))):
        g2, _ = build_optimized_graph(ds.x, ds.senders, ds.receivers,
                                      y=ds.y, train_mask=ds.train_mask,
                                      layer_name="GCNConv", seed=0, **kw)
        check(torch.equal(g2.senders, g.senders)
              and torch.equal(g2.receivers, g.receivers),
              f"{name}: node order differs from the default operator's")
        ops[name] = g2.aux
    ops["rowwalk"] = build_hybrid(
        g.senders.numpy(), g.receivers.numpy(), g.edge_weight.numpy(),
        g.num_nodes_padded, min_block_edges=48, use_segmm=True,
        use_rowwalk=True)
    print(f"opt-in ingest: {time.perf_counter() - t0:.1f} s")
    hd, b0 = ops["diag"], g.aux.bsr
    diag_nz = int((hd.diag_blocks != 0).flatten(1).any(1).sum())
    print(f"use_diag: {hd.diag_blocks.shape[0]} diagonal blocks "
          f"({diag_nz} non-zero), diag_r={hd.diag_r}, "
          f"{0 if hd.bsr is None else hd.bsr.nnz_blocks} off-diagonal "
          f"tiles with fillers")
    check(hd.diag_r > 0 and hd.bsr is not None,
          "use_diag: expected the K8 chain with off-diagonal tiles")
    bg, br = ops["group2"].bsr, ops["rowwalk"].bsr
    splits = br.row_splits
    print(f"tile_group=2: {bg.nnz_blocks} tiles (grid walk: "
          f"{b0.nnz_blocks}); rowwalk: {br.nnz_blocks} tiles, "
          f"{int((splits[1:] == splits[:-1]).sum())} block rows without one")
    for name in ("group2", "rowwalk"):
        check(torch.equal(ops[name].senders, g.aux.senders),
              f"{name}: straggler split differs from the default operator's")
    return ops


def phase_optin_kernels(device, g, ops) -> dict:
    """K2, K9 and K10 at F=128 and 512 on their layouts, K8 forward and
    transpose with and without init at F=128 and 512, and K11 at (N_pad,
    512) bit for bit, each against its plain version."""
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_plain,
                                               bsr_spmm_rowwalk)
    from fitgnn_tpu_torch.ops.diag_spmm import diag_spmm, diag_spmm_plain
    from fitgnn_tpu_torch.ops.dropout import (philox_dropout,
                                              philox_dropout_plain,
                                              seed_from_generator)

    n = g.num_nodes_padded
    b0 = g.aux.bsr.to(device)
    walks = {"K2": (b0, bsr_spmm_fwd),
             "K9": (ops["group2"].bsr.to(device), bsr_spmm_grouped),
             "K10": (ops["rowwalk"].bsr.to(device), bsr_spmm_rowwalk)}
    diag, r8 = ops["diag"].diag_blocks.to(device), ops["diag"].diag_r
    # the three walks compute one function: the grid walk's tile non-zeros
    a_tiles, nnz = tile_csr(b0, n)
    nz_tile = (b0.blocks != 0).flatten(1).any(1)
    tiles = int(nz_tile.sum())
    uniq_cols = int(torch.unique(b0.cols[nz_tile]).numel())
    nb = n // 128
    diag_live = (diag != 0).flatten(1).any(1)
    diag_nnz = int((diag != 0).sum())
    row_nnz = (diag != 0).sum(2).flatten().float()
    print(f"K8 diagonal blocks: {diag.shape[0]} ({int(diag_live.sum())} with "
          f"a non-zero), {diag_nnz} non-zeros, fill "
          f"{diag_nnz / diag.numel():.4f}, {float(row_nnz.mean()):.2f} a row "
          f"on average, {int(row_nnz.max())} at most")
    gen = torch.Generator(device=device).manual_seed(4)
    shapes = {k: [] for k in ("K2", "K9", "K10", "K8", "K11")}

    def show(k):
        sh = shapes[k][-1]
        lib = sh["library_ms"]
        print(f"  {k} {sh['shape']}: kernel_ms={sh['ms']:.4f} "
              f"plain_ms={sh['plain_ms']:.4f} library_ms="
              f"{'null' if lib is None else f'{lib:.4f}'} "
              f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")

    with torch.inference_mode():
        for feat in (NUM_FEATURES, HIDDEN):
            x = torch.randn((n, feat), generator=gen, device=device)
            init = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            ref = bsr_spmm_plain(b0, x)
            lib = torch.sparse.mm(a_tiles, x)
            compare(f"tile walks library torch.sparse.mm F={feat}", lib, ref)
            # the walks' function: every tile with a non-zero read once,
            # the slabs of the distinct input blocks, the output written;
            # 2 FLOPs per tile non-zero and feature
            bw, byw = bound(tiles * 128 * 128 * 4 + (tiles + nb + 1) * 4
                            + uniq_cols * 128 * feat * 4 + n * feat * 4,
                            2.0 * nnz * feat)
            lib_ms = cuda_ms(lambda: torch.sparse.mm(a_tiles, x), 20)
            for k, (b, walk) in walks.items():
                got = walk(b, x)
                torch.cuda.synchronize()
                err = compare(f"{k} {walk.__name__} F={feat}", got,
                              bsr_spmm_plain(b, x))
                compare(f"{k} vs the grid walk's plain version F={feat}",
                        got, ref)
                shapes[k].append(dict(
                    F=feat, shape=f"F={feat}", **err, bound_ms=bw,
                    bound_by=byw, ms=cuda_ms(lambda: walk(b, x), 20),
                    plain_ms=cuda_ms(lambda: bsr_spmm_plain(b, x), 5),
                    library_ms=lib_ms))
                show(k)
            del got, ref, lib
            # K8: blocks, x, init once, out once; 2 FLOPs per block
            # non-zero and feature.  On the path: F=128 forward (layer 0),
            # F=512 forward and transpose (layer 1), each with init.
            x3, i3 = x.reshape(nb, 128, feat), init.reshape(nb, 128, feat)
            for transpose in (False, True):
                a3 = diag.transpose(1, 2) if transpose else diag
                for with_init in (True, False):
                    it = init if with_init else None
                    got = diag_spmm(diag, x, r8, transpose, it)
                    torch.cuda.synchronize()
                    tag = (f"F={feat}{' transpose' if transpose else ''}"
                           f"{' init' if with_init else ''}")
                    err = compare(f"K8 diag_spmm {tag}", got,
                                  diag_spmm_plain(diag, x, r8, transpose, it))

                    def lib8(a3=a3, with_init=with_init):
                        if with_init:
                            return torch.baddbmm(i3, a3, x3)
                        return torch.bmm(a3, x3)

                    compare(f"K8 library torch.baddbmm {tag}",
                            lib8().reshape(n, feat),
                            diag_spmm_plain(diag, x, r8, transpose, it))
                    b8, by8 = bound(int(diag_live.sum()) * 128 * 128 * 4
                                    + n * feat * 4 * (3 if with_init else 2),
                                    2.0 * diag_nnz * feat)
                    shapes["K8"].append(dict(
                        F=feat, shape=tag, transpose=transpose,
                        init=with_init,
                        on_path=with_init and (feat == HIDDEN
                                               or not transpose),
                        **err, bound_ms=b8, bound_by=by8,
                        ms=cuda_ms(lambda: diag_spmm(diag, x, r8, transpose,
                                                     it), 20),
                        plain_ms=cuda_ms(lambda: diag_spmm_plain(
                            diag, x, r8, transpose, it), 5),
                        library_ms=cuda_ms(lib8, 20)))
                    show("K8")
            del x, init, x3, i3, got
        # K11 at the layer output's shape, bit for bit
        x = torch.randn((n, HIDDEN), generator=gen, device=device)
        seed = seed_from_generator(gen, device)
        got = philox_dropout(x, seed, 0.5)
        ref = philox_dropout_plain(x, seed, 0.5)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), "K11: kernel and plain version differ")
        kept = float((got != 0).float().mean())
        print(f"K11 philox_dropout: bit-exact, kept {kept:.5f} of "
              f"{x.numel()} at rate 0.5")
        check(abs(kept - 0.5) < 4 * (0.25 / x.numel()) ** 0.5,
              "K11: keep rate outside 4 sigma")
        # x read once, out written once, one f32 multiply an element (the
        # Philox integer rounds, ~25 operations an element, have no rate in
        # the f32 table and would bind below the bytes anyway)
        b11, by11 = bound(2 * x.numel() * 4 + 4, float(x.numel()))
        shapes["K11"].append(dict(
            F=HIDDEN, shape=f"({n}, {HIDDEN})", max_abs_err=0.0,
            max_rel_err=0.0, bit_exact=True, bound_ms=b11, bound_by=by11,
            ms=cuda_ms(lambda: philox_dropout(x, seed, 0.5), 20),
            plain_ms=cuda_ms(lambda: philox_dropout_plain(x, seed, 0.5), 3),
            library_ms=cuda_ms(lambda: torch.nn.functional.dropout(
                x, 0.5, training=True), 20),
            library_label="torch.nn.functional.dropout (its own mask "
                          "stream)"))
        show("K11")
        del x, got, ref
    torch.cuda.empty_cache()
    return shapes


# launches of one training step and one eval forward of a 2-layer model at
# hidden 512, read from the autograd graph and confirmed by phase 4:
# GAT layer 0 aggregates the raw 128-wide features (no dx, so no K4ᵀ),
# layer 1 the 512-wide transformed ones; GCN layer 0 aggregates the raw
# features (no backward), layer 1 its transformed input
STEP = {"GATConv": {"K4": 2, "K4T": 1, "K5": 2},
        "GCNConv": {"K1": 3, "K3": 3},
        # FUSED: the score pass and its column sum in both layers, K7bt's
        # dx walk and K6's dx (a K3w launch) in layer 1 only
        "GATConv fused": {"K7f": 2, "K7bt": 1, "K7s": 2, "K7sums": 2,
                          "K6": 2, "K3w": 1},
        "GATConv fused exact": {"K7rm": 2, "K7f": 2, "K7bt": 1, "K7s": 2,
                                "K7sums": 2}}
EVAL = {"GATConv": {"K4": 2}, "GCNConv": {"K1": 2, "K3": 2},
        "GATConv fused": {"K7f": 2, "K6": 2},
        "GATConv fused exact": {"K7rm": 2, "K7f": 2},
        "GATConv fused tiles": {"K7f": 2}}
# the switches of each mode
MODE_ENV = {"GATConv": {}, "GCNConv": {}, "GATConv fused": FUSED,
            "GATConv fused exact": FUSED_EXACT,
            "GATConv fused tiles": FUSED_ONLY}


def phase_gradients(device, g_gat, g_gcn) -> None:
    """One training step with the kernels, then with the plain versions
    patched in: the loss and every gradient, and the step's launches."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops import att_bsr, bsr_dynamic, coo_segmm
    from fitgnn_tpu_torch.ops import hybrid_spmm as hybrid_mod
    from fitgnn_tpu_torch.ops import tile_gat
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm_plain
    from fitgnn_tpu_torch.train.losses import masked_nll

    plain = [
        mock.patch.object(hybrid_mod, "bsr_spmm_acc", bsr_spmm_acc_plain),
        mock.patch.object(hybrid_mod, "segmm_spmm", segmm_spmm_plain),
        mock.patch.object(bsr_dynamic, "dyn_tiles",
                          bsr_dynamic.dyn_tiles_plain),
        mock.patch.object(bsr_dynamic, "dyn_tiles_t",
                          bsr_dynamic.dyn_tiles_t_plain),
        mock.patch.object(bsr_dynamic, "dyn_grad_blocks",
                          bsr_dynamic.dyn_grad_blocks_plain),
        mock.patch.object(coo_segmm, "segmm_weighted_raw",
                          coo_segmm.segmm_weighted_raw_plain),
        mock.patch.object(coo_segmm, "segmm_weighted_den_raw",
                          coo_segmm.segmm_weighted_den_raw_plain),
        mock.patch.object(tile_gat, "att_rowmax", att_bsr.att_rowmax_plain),
        mock.patch.object(att_bsr, "att_fwd", att_bsr.att_fwd_plain),
        mock.patch.object(att_bsr, "att_bwd_t", att_bsr.att_bwd_t_plain),
        mock.patch.object(att_bsr, "att_bwd_scores",
                          att_bsr.att_bwd_scores_plain)]
    default_gat = None
    for mode, g in (("GATConv", g_gat), ("GCNConv", g_gcn),
                    ("GATConv fused", g_gat)):
        layer = mode.split()[0]
        gd = g.to(device)
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                          dropout_rate=0.0)
        model.reset_parameters(torch.Generator().manual_seed(0))
        model = model.to(device).train()

        def step():
            model.zero_grad(set_to_none=True)
            loss = masked_nll(model(gd.x, gd), gd.y, gd.train_mask)
            loss.backward()
            torch.cuda.synchronize()
            return loss.detach(), {k: p.grad.detach().clone()
                                   for k, p in model.named_parameters()}

        with switches(MODE_ENV[mode]):
            reset_counts()
            loss_k, grads_k = step()
            expect(read_counts(), STEP[mode], f"{mode} train step")
            reset_counts()
            for patch in plain:
                patch.start()
            try:
                loss_p, grads_p = step()
            finally:
                for patch in plain:
                    patch.stop()
        expect(read_counts(), {}, f"{mode} train step, plain versions")
        compare(f"{mode} loss kernels vs plain", loss_k.reshape(1),
                loss_p.reshape(1))
        for k in grads_p:
            compare(f"{mode} grad {k}", grads_k[k], grads_p[k])
        if mode == "GATConv":
            default_gat = (loss_k, grads_k)
        elif layer == "GATConv":
            # the same step through the two-stage path (the default)
            compare(f"{mode} loss vs the default step",
                    loss_k.reshape(1), default_gat[0].reshape(1))
            for k in grads_k:
                compare(f"{mode} grad {k} vs the default step", grads_k[k],
                        default_gat[1][k])
        del model, gd, grads_k, grads_p
        torch.cuda.empty_cache()


# launches of one GCN training step and one eval forward on each opt-in
# operator (hidden 512, dropout 0.5 through K11): layer 0 aggregates the
# raw features (forward only), layer 1 forward and backward; K11 after each
# layer, forward and backward
OPTIN_STEP = {"diag": {"K3": 3, "K8": 3, "K1": 3, "K11": 4},
              "group2": {"K3": 3, "K9": 3, "K11": 4},
              "rowwalk": {"K3": 3, "K10": 3, "K11": 4}}
OPTIN_EVAL = {"diag": {"K3": 2, "K8": 2, "K1": 2},
              "group2": {"K3": 2, "K9": 2}, "rowwalk": {"K3": 2, "K10": 2}}
OPTIN_EPOCHS = 2


def phase_optin_train(device, g, ops) -> dict:
    """GCNConv at hidden 512 with ``fused_dropout=True, bit_dropout=False``
    (dropout 0.5, so K11 runs) on each opt-in operator: one step's loss and
    gradients against the default operator's under the same seed (the same
    K11 masks), then ``OPTIN_EPOCHS`` epochs (a ``gc_train_step`` and a
    ``gc_eval_step`` each) with every counter at 0 just before, and an eval
    forward against the default operator's."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train import steps
    from fitgnn_tpu_torch.train.losses import masked_nll

    def model_():
        m = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                      dropout_rate=0.5, fused_dropout=True,
                      bit_dropout=False)
        return m.reset_parameters(torch.Generator().manual_seed(0)).to(
            device)

    def one_step(gd):
        model = model_().train()
        gen = torch.Generator(device=device).manual_seed(0)
        loss = masked_nll(model(gd.x, gd, gen), gd.y, gd.train_mask)
        loss.backward()
        model.eval()
        with torch.inference_mode():
            out = model(gd.x, gd)
        torch.cuda.synchronize()
        return loss.detach(), {k: p.grad.detach().clone()
                               for k, p in model.named_parameters()}, out

    gd0 = g.to(device)
    loss0, grads0, out0 = one_step(gd0)
    del gd0
    phases = {}
    for name, h in ops.items():
        gd = g._replace(aux=h).to(device)
        loss, grads, out = one_step(gd)
        compare(f"{name} step loss vs the default operator",
                loss.reshape(1), loss0.reshape(1))
        for k in grads0:
            compare(f"{name} grad {k} vs the default operator", grads[k],
                    grads0[k])
        compare(f"{name} eval forward vs the default operator", out, out0)
        model = model_()
        opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
        gen = torch.Generator(device=device).manual_seed(0)
        evals = ~gd.train_mask
        losses = []
        reset_counts()
        t0 = time.perf_counter()
        for _ in range(OPTIN_EPOCHS):
            losses.append(steps.gc_train_step(model, opt, gd, gd.y,
                                              gd.train_mask, gen,
                                              "classification"))
            losses.append(steps.gc_eval_step(model, gd, gd.y, evals,
                                             "classification")[0])
        torch.cuda.synchronize()
        launches, wall = read_counts(), time.perf_counter() - t0
        losses = [float(v) for v in losses]
        check(all(np.isfinite(v) and v > 0 for v in losses),
              f"{name}: bad losses {losses}")
        print(f"train gcn512 {name}: {OPTIN_EPOCHS} epochs in {wall:.2f} s, "
              f"losses {[round(v, 4) for v in losses]}")
        want = {k: OPTIN_EPOCHS * (OPTIN_STEP[name].get(k, 0)
                                   + OPTIN_EVAL[name].get(k, 0))
                for k in (*OPTIN_STEP[name], *OPTIN_EVAL[name])}
        expect(launches, want, f"train gcn512 {name}")
        phases[f"train gcn512 {name}"] = launches
        del gd, model, opt, grads
        torch.cuda.empty_cache()
    return phases


def phase_forward_only(device, g) -> dict:
    """K2 on its paths: eval forwards of the GCN model on a forward-only
    operator (the BCSR without its transpose: K3 then K2 per layer), held
    against the default operator's forward, and ``spmm(operator=
    BsrMatrix)`` forward and backward at F=512."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_plain
    from fitgnn_tpu_torch.ops.spmm import spmm

    h = g.aux
    fwd_only = dataclasses.replace(h, bsr=dataclasses.replace(
        h.bsr, transpose=None))
    gd, gf = g.to(device), g._replace(aux=fwd_only).to(device)
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(
        device).eval()
    forwards = 4
    with torch.inference_mode():
        ref = model(gd.x, gd)
        reset_counts()
        outs = [model(gf.x, gf) for _ in range(forwards)]
        torch.cuda.synchronize()
        serve = read_counts()
    expect(serve, {"K3": 2 * forwards, "K2": 2 * forwards},
           "serve gcn512 forward-only")
    for out in outs[:1]:
        compare("forward-only operator vs the default operator", out, ref)
    b = gd.aux.bsr
    gen = torch.Generator(device=device).manual_seed(6)
    x = torch.randn((g.num_nodes_padded, HIDDEN), generator=gen,
                    device=device, requires_grad=True)
    gr = torch.randn((g.num_nodes_padded, HIDDEN), generator=gen,
                     device=device)
    reset_counts()
    out = spmm(None, None, None, x, g.num_nodes_padded, operator=b)
    out.backward(gr)
    torch.cuda.synchronize()
    lib = read_counts()
    expect(lib, {"K2": 2}, "spmm(operator=BsrMatrix) forward and backward")
    with torch.inference_mode():
        compare("spmm(operator=BsrMatrix) vs plain", out.detach(),
                bsr_spmm_plain(b, x.detach()))
        compare("spmm(operator=BsrMatrix) dx vs plain", x.grad,
                bsr_spmm_plain(b.transpose, gr))
    del gd, gf, x, gr, out
    torch.cuda.empty_cache()
    return {"serve gcn512 forward-only": serve,
            "spmm BsrMatrix fwd+bwd F=512": lib}


def run_cli(tmp, argv, env=None) -> tuple:
    """Run the port's CLI from ``tmp`` under the switches ``env`` with every
    counter at 0 just before; returns (launches, NodeModel forwards,
    seconds)."""
    from fitgnn_tpu_torch.cli.main import main as cli_main
    from fitgnn_tpu_torch.models.models import NodeModel

    forwards = [0]

    def count_forward(module, args, output):
        if isinstance(module, NodeModel):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(
        count_forward)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with switches(env or {}):
            reset_counts()
            t0 = time.perf_counter()
            rc = cli_main([*argv, "--dataset", "bench", "--data_root",
                           os.path.join(tmp, "dataset"), "--experiment",
                           "random", "--device", "cuda"])
            torch.cuda.synchronize()
            launches, wall = read_counts(), time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        hook.remove()
    check(rc == 0, f"{argv[0]} returned {rc}")
    return launches, forwards[0], wall


def expect(launches: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in launches.items() if v}
    want = {k: v for k, v in want.items() if v}
    print(f"{what}: launches {got}")
    check(got == want, f"{what}: launches {got}, expected {want}")


def phase_train(tmp) -> dict:
    """``train --baseline`` through the CLI: GAT 512 (3 epochs), GCN 512 (2
    epochs), GAT 64 (1 epoch, K3w), GAT 512 under ``FUSED`` (2 epochs) and
    ``FUSED_EXACT`` (1 epoch).  Per epoch one train step and one val
    forward; per run a warm-up and a timed test forward."""
    from fitgnn_tpu_torch.utils.results import TRAIN_NODE_CLS_HEADER

    phases = {}
    runs = (("gat512", "GATConv", HIDDEN, 3),
            ("gcn512", "GCNConv", HIDDEN, 2),
            ("gat64", "GATConv", 64, 1),
            ("gat512fused", "GATConv fused", HIDDEN, 2),
            ("gat512exact", "GATConv fused exact", HIDDEN, 1))
    from fitgnn_tpu_torch.ops import coo_segmm

    launch, widths = coo_segmm._launch, {}

    def k3w_widths(what, m, x, *args, **kwargs):
        """The straggler sum's launch as it is, tallying K3w's widths."""
        if what == "segmm_weighted_raw":
            widths[x.shape[1]] = widths.get(x.shape[1], 0) + 1
        return launch(what, m, x, *args, **kwargs)

    for out_dir, mode, hidden, epochs in runs:
        with mock.patch.object(coo_segmm, "_launch", k3w_widths):
            launches, _, wall = run_cli(tmp, [
                "train", "--baseline", "--layer_name", mode.split()[0],
                "--hidden", str(hidden), "--runs", "1", "--epochs1",
                str(epochs), "--output_dir", out_dir], MODE_ENV[mode])
        print(f"train {out_dir}: {wall:.1f} s")
        if hidden == 64:
            # K3w's F=40 row of phase 3 (the class count) is off the path
            print(f"train {out_dir}: K3w widths {widths}")
            check(set(widths) == {64}, f"K3w at hidden 64 ran at widths "
                  f"{widths}, expected 64 alone")
        widths.clear()
        if hidden == HIDDEN:
            want = {k: epochs * (STEP[mode].get(k, 0)
                                 + EVAL[mode].get(k, 0))
                    + 2 * EVAL[mode].get(k, 0)
                    for k in (*STEP[mode], *EVAL[mode])}
        else:
            # at hidden 64 layer 0 is 128 → 64, so both layers aggregate
            # transformed (64-wide) features: K4ᵀ twice per step, and the
            # stragglers take K3w, forward and dx, in every layer
            want = {"K4": epochs * 4 + 4, "K4T": epochs * 2,
                    "K5": epochs * 2, "K3w": epochs * (4 + 2) + 4}
        expect(launches, want, f"train {out_dir}")
        ckpt = os.path.join(tmp, "save", "node_cls", "baseline", out_dir,
                            "model.pt")
        check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
        phases[f"train {out_dir}"] = launches
    with open(os.path.join(tmp, "results", "baseline", "bench.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == TRAIN_NODE_CLS_HEADER and len(lines) == 1 + len(runs),
          f"train CSV not written under the header: {lines[:2]}")
    for line in lines[1:]:
        row = dict(zip(lines[0].split(","), line.split(",")))
        loss = float(row["best_loss"])
        check(np.isfinite(loss) and loss > 0, f"bad loss in row {line}")
        print(f"train row: layer={row['layer_name']} hidden={row['hidden']} "
              f"best_acc={row['best_acc']} best_loss={row['best_loss']} "
              f"ave_time={row['ave_time']}")
    return phases


def phase_gat_serve(tmp) -> dict:
    """``infer-baseline`` for GAT 512 from the default run's checkpoint, then
    under ``FUSED_TILES=1`` from the fused run's."""
    phases = {}
    for out_dir, mode in (("gat512", "GATConv"),
                          ("gat512fused", "GATConv fused tiles")):
        launches, forwards, wall = run_cli(tmp, [
            "infer-baseline", "--layer_name", "GATConv", "--hidden",
            str(HIDDEN), "--num_test_samples", "8", "--output_dir", out_dir],
            MODE_ENV[mode])
        print(f"serve {out_dir}: infer-baseline took {wall:.1f} s, "
              f"{forwards} forwards")
        check(forwards > 0, "no forward ran")
        expect(launches, {k: v * forwards for k, v in EVAL[mode].items()},
               f"serve {out_dir}")
        with open(os.path.join(tmp, "inference_results",
                               "node_cls.csv")) as f:
            lines = f.read().splitlines()
        row = dict(zip(lines[0].split(","), lines[-1].split(",")))
        check(row["layer_name"] == "GATConv"
              and float(row["avg_inf_time_device"]) > 0,
              f"bad GAT serve row {lines[-1]}")
        print(f"{out_dir} avg_inf_time={row['avg_inf_time']} "
              f"avg_inf_time_device={row['avg_inf_time_device']} "
              f"acc={row['acc']}")
        phases[f"serve {out_dir}"] = launches
    return phases


def phase_serve(device, tmp, g) -> tuple:
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops import hybrid_spmm as hybrid_mod
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm_plain
    from fitgnn_tpu_torch.utils.results import INFERENCE_HEADER

    launches, forwards, wall = run_cli(tmp, [
        "infer-baseline", "--hidden", str(HIDDEN), "--num_test_samples",
        "8"])
    print(f"serve: infer-baseline took {wall:.1f} s, {forwards} forwards")
    check(forwards > 0, "no forward ran")
    expect(launches, {"K1": 2 * forwards, "K3": 2 * forwards}, "serve GCN")

    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER,
          f"CSV not written under INFERENCE_HEADER: {lines[:2]}")
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    avg, avg_dev = float(row["avg_inf_time"]), float(row["avg_inf_time_device"])
    check(row["layer_name"] == "GCNConv" and np.isfinite(avg) and avg > 0
          and np.isfinite(avg_dev) and avg_dev > 0,
          f"bad GCN serve row {lines[-1]}")
    print(f"avg_inf_time={avg} avg_inf_time_device={avg_dev} "
          f"acc={row['acc']} avg_loss={row['avg_loss']}")

    # the same forward (same graph, same seed-0 init) with kernels, then
    # with the plain versions on the card
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(device).eval()
    gd = g.to(device)
    with torch.inference_mode():
        out_k = model(gd.x, gd)
        with mock.patch.object(hybrid_mod, "bsr_spmm_acc",
                               bsr_spmm_acc_plain), \
                mock.patch.object(hybrid_mod, "segmm_spmm",
                                  segmm_spmm_plain):
            out_p = model(gd.x, gd)
    torch.cuda.synchronize()
    check(out_k.shape == (g.num_nodes_padded, NUM_CLASSES),
          f"log-probs shape {tuple(out_k.shape)}")
    check(bool(torch.isfinite(out_k).all()), "non-finite log-probs")
    psum = out_k.exp().sum(-1)
    check(bool(((psum - 1).abs() < 1e-4).all()), "rows are not distributions")
    err = float((out_k - out_p).abs().max())
    print(f"forward kernels vs plain: max_abs_err={err:.3e} (atol 1e-4)")
    check(err <= 1e-4, "forward with kernels disagrees with plain forward")
    return {"serve gcn": launches}, avg, avg_dev


# the curriculum phase: (output dir, layer, setup, gradient method, epochs1,
# epochs2); the Gc epochs launch the confirmed STEP + EVAL counts each, the
# Gs epochs and evals none
CURRICULUM = (
    ("cur_gcn", "GCNConv", "Gc_train_2_Gs_infer", "GD", 2, 0),
    ("cur_gcn_gd", "GCNConv", "Gc_train_2_Gs_train", "GD", 1, 1),
    ("cur_gcn_mb", "GCNConv", "Gc_train_2_Gs_train", "MB", 1, 1),
    ("cur_gcn_gs", "GCNConv", "Gs_train_2_Gs_infer", "GD", 0, 1),
    ("cur_gat", "GATConv", "Gc_train_2_Gs_infer", "GD", 1, 0))
# subgraphs held on the card against the CPU (the batched dense branch)
CURRICULUM_CHECK_SUBGRAPHS = 4096


def phase_curriculum(device, tmp, serve_avg, serve_avg_dev) -> dict:
    """The FIT-GNN curriculum through the port's CLI on the bench graph at
    hidden 512: the partition (computed once, then from the cache), the
    runs of ``CURRICULUM``, the subgraph ``infer`` from the first run's
    checkpoint beside the GCN ``infer-baseline`` row, and the batched Gs
    eval forward on the card against the CPU's."""
    from fitgnn_tpu_torch.graph import optimize as optimize_mod
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.partition import pipeline
    from fitgnn_tpu_torch.train import loop
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.results import (INFERENCE_HEADER,
                                                TRAIN_NODE_CLS_HEADER)

    seen = {"partitions": [], "gc": [], "runs": []}
    partition, optimize, run_task = (pipeline.coarsen_and_partition,
                                     optimize_mod.optimize_coarse,
                                     loop.run_node_task)

    def timed_partition(*args, **kwargs):
        t0 = time.perf_counter()
        part = partition(*args, **kwargs)
        seen["partitions"].append((time.perf_counter() - t0, part))
        return part

    def traced_optimize(coarse, **kwargs):
        out = optimize(coarse, **kwargs)
        hyb = out.graph.aux
        seen["gc"].append((int(out.graph.n_node), out.graph.num_nodes_padded,
                           0 if hyb.bsr is None else hyb.bsr.nnz_blocks,
                           hyb.num_coo_edges))
        return out

    def traced_run(cfg, coarse, batch, verbose=False):
        res = run_task(cfg, coarse, batch, verbose=verbose)
        seen.setdefault("batch", batch)     # the first run's, on the host
        seen["runs"].append(res)
        return res

    phases, rows = {}, {}
    patches = (mock.patch.object(pipeline, "coarsen_and_partition",
                                 timed_partition),
               mock.patch.object(optimize_mod, "optimize_coarse",
                                 traced_optimize),
               mock.patch.object(loop, "run_node_task", traced_run))
    for patch in patches:
        patch.start()
    try:
        for i, (out_dir, layer, setup, method, ep1, ep2) in enumerate(
                CURRICULUM):
            torch.cuda.reset_peak_memory_stats()
            launches, _, wall = run_cli(tmp, [
                "train", "--layer_name", layer, "--hidden", str(HIDDEN),
                "--exp_setup", setup, "--gradient_method", method,
                "--epochs1", str(ep1), "--epochs2", str(ep2), "--runs", "1",
                "--output_dir", out_dir])
            if i == 0:
                check(len(seen["partitions"]) == 1,
                      "the first curriculum run did not partition")
                secs, part = seen["partitions"][0]
                b = part.subgraphs
                print(f"curriculum partition: {secs:.2f} s host, "
                      f"{part.num_metanodes} metanodes, Gc "
                      f"{int(part.coarse.graph.n_node)} nodes; subgraph "
                      f"batch (S, N_pad, E_pad) = ({b.num_subgraphs}, "
                      f"{b.num_nodes_padded}, {b.senders.shape[1]})")
                del part, b
            else:
                check(len(seen["partitions"]) == 1,
                      f"curriculum {out_dir} did not take the partition "
                      "from the cache")
            want = {k: ep1 * (STEP[layer].get(k, 0) + EVAL[layer].get(k, 0))
                    for k in (*STEP[layer], *EVAL[layer])}
            expect(launches, want, f"curriculum {out_dir}")
            res = seen["runs"][-1].runs[0]
            check(np.isfinite(res.test_loss) and res.test_loss > 0,
                  f"curriculum {out_dir}: test loss {res.test_loss}")
            gc_ms = [round(t * 1e3, 3) for t in res.gc_epoch_seconds]
            gs_s = [round(t, 4) for t in res.gs_epoch_seconds]
            if ep1:
                n, n_pad, tiles, stragglers = seen["gc"][-1]
                print(f"curriculum {out_dir}: Gc {n} nodes (N_pad {n_pad}): "
                      f"{tiles} tiles, {stragglers} straggler edges")
                check(tiles > 0 and stragglers > 0,
                      f"curriculum {out_dir}: Gc took no hybrid operator")
            print(f"curriculum {out_dir}: {wall:.1f} s; Gc epoch ms "
                  f"{gc_ms}; Gs epoch s {gs_s} ({method}); test eval "
                  f"{res.test_time * 1e3:.3f} ms; test loss "
                  f"{res.test_loss:.4f} metric {res.test_acc:.4f}; peak "
                  f"device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            ckpt = os.path.join(tmp, "save", "node_cls", out_dir, "model.pt")
            check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
            phases[f"curriculum {out_dir}"] = launches
    finally:
        for patch in patches:
            patch.stop()
    batch = seen.pop("batch")
    del seen

    with open(os.path.join(tmp, "results", "bench.csv")) as f:
        header, *lines = f.read().splitlines()
    check(header == TRAIN_NODE_CLS_HEADER and len(lines) == len(CURRICULUM),
          f"curriculum CSV not written under the header: {header}")
    for line in lines:
        row = dict(zip(header.split(","), line.split(",")))
        check(np.isfinite(float(row["best_loss"])) and
              float(row["ave_time"]) > 0, f"bad curriculum row {line}")

    # serve each sampled node from its subgraph: no kernel launches
    launches, forwards, wall = run_cli(tmp, [
        "infer", "--hidden", str(HIDDEN), "--num_test_samples", "64",
        "--output_dir", "cur_gcn"])
    expect(launches, {}, "curriculum infer")
    phases["curriculum infer"] = launches
    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(lines[0] == INFERENCE_HEADER, "infer CSV header")
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    avg, avg_dev = float(row["avg_inf_time"]), float(row["avg_inf_time_device"])
    check(row["exp_setup"] == "fitgnn" and avg > 0 and avg_dev > 0
          and np.isfinite(float(row["acc"])), f"bad infer row {lines[-1]}")
    print(f"curriculum infer: {wall:.1f} s, {forwards} forwards")
    print(f"serve GCN hidden {HIDDEN}: subgraph infer avg_inf_time={avg} "
          f"avg_inf_time_device={avg_dev} acc={row['acc']} | "
          f"infer-baseline avg_inf_time={serve_avg} "
          f"avg_inf_time_device={serve_avg_dev} | ratio "
          f"{serve_avg / avg:.1f}x wall, {serve_avg_dev / avg_dev:.1f}x "
          "device")

    # the batched Gs eval forward on the card against the CPU's
    sub = batch.slice(0, CURRICULUM_CHECK_SUBGRAPHS)
    for layer, out_dir in (("GCNConv", "cur_gcn"), ("GATConv", "cur_gat")):
        model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
        model.load_state_dict(restore_params(
            os.path.join(tmp, "save", "node_cls", out_dir, "model.pt")))
        model.eval()
        with torch.inference_mode():
            ref = model(sub.x, sub.graphs())
            reset_counts()
            got = model.to(device)(sub.x.to(device),
                                   sub.graphs().to(device)).cpu()
            expect(read_counts(), {}, f"curriculum {layer} batched forward")
        compare(f"curriculum {layer} batched Gs forward, {sub.num_subgraphs} "
                "subgraphs, cuda vs cpu", got, ref)
    return phases


def summarize(name, route, source, replaces, launches, per_shape) -> dict:
    """One kernel's line: times and bounds summed over the shapes one step
    or forward launches it at (those not marked ``on_path: False``); errors
    are the worst over every shape checked; ``launches`` is the sum over
    the main-path phases, ``launches_by_phase`` beside it."""
    path = [s for s in per_shape if s.get("on_path", True)]
    top = max(path, key=lambda s: s["bound_ms"])
    libs = [s["library_ms"] for s in path]
    extra = {}
    if "two_stage_label" in top:
        # a yardstick may cover several rows (K7bt's two launches): it sits
        # on one of them and is None on the others
        twos = [s["two_stage_ms"] for s in path
                if s["two_stage_ms"] is not None]
        extra = {"two_stage_ms": sum(twos) if twos else None,
                 "two_stage_label": top["two_stage_label"]}
    if "library_label" in top:
        extra["library_label"] = top["library_label"]
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "status": "ok",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "ms": sum(s["ms"] for s in path),
        "plain_ms": sum(s["plain_ms"] for s in path),
        "bound_ms": sum(s["bound_ms"] for s in path),
        "bound_by": top["bound_by"],
        "library_ms": None if None in libs else sum(libs),
        **extra,
        "per_shape": per_shape,
    }


KERNELS = (
    ("K1", "K1 bsr_spmm_acc", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K3", "K3 segmm_spmm", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:187"),
    ("K4", "K4 dyn_tiles (bsr_spmm_dyn forward)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4T", "K4 dyn_tiles_t (bsr_spmm_dyn dx, transposed)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5", "K5 dyn_grad_blocks (bsr_spmm_dyn dblocks)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
    ("K3w", "K3w segmm_weighted_raw (segmm_weighted_spmm)",
     "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:370"),
    ("K6", "K6 segmm_weighted_den_raw (segmm_weighted_spmm_den)",
     "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:236"),
    ("K7rm", "K7 att_rowmax", "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:78"),
    ("K7f", "K7 att_fwd (att_tiles forward: the rows walk, pe per "
     "non-zero)", "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:125"),
    ("K7bt", "K7 att_bwd_t dx (att_tiles dx: the columns walk of "
     "tile_sparse.cuh, pe per non-zero)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K7s", "K7 att_bwd_scores (att_tiles' score gradients: each forward "
     "tile's row and column partials of d_raw in one tensor-core pass; "
     "replaces _bwd_f_kernel and the dssrc half of _bwd_t_kernel, :185)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:267"),
    ("K7sums", "K7 att_sums (dsdst and dssrc from the pass's partials, over "
     "the forward walk and the transpose plan: the tile sums of "
     "_bwd_f_kernel and _bwd_t_kernel)",
     "fitgnn_tpu_torch/csrc/att_bsr.cu",
     "fitgnn_tpu/ops/pallas/att_bsr.py:185"),
    ("K2", "K2 bsr_spmm_fwd (bsr_spmm from zero)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:156"),
    ("K8", "K8 diag_spmm (diag_spmm_raw)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/diag_spmm.py:34"),
    ("K9", "K9 bsr_spmm_grouped (grouped tile walk)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:264"),
    ("K10", "K10 bsr_spmm_rowwalk (row walk)",
     "fitgnn_tpu_torch/csrc/tile_sparse.cuh",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:330"),
    ("K11", "K11 philox_dropout (fused_dropout forward and backward)",
     "fitgnn_tpu_torch/csrc/dropout.cu",
     "fitgnn_tpu/ops/pallas/dropout.py:29"),
)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a GPU", file=sys.stderr)
        return 1
    from fitgnn_tpu_torch.data.datasets import NodeDataset, save_npz_cache
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()
    regs = phase_build()
    phase_small_reference(device)

    x, s, r, y, train = make_graph()
    rest = ~train
    val = rest & (np.random.default_rng(1).random(NUM_NODES) < 0.2)
    ds = NodeDataset("bench", x, s, r, y, train_mask=train, val_mask=val,
                     test_mask=rest & ~val)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "dataset", "bench"))
        save_npz_cache(os.path.join(tmp, "dataset", "bench", "bench.npz"), ds)
        g, _, shapes = phase_kernels(device, ds)
        g_gat, gat_shapes = phase_gat_kernels(device, ds, g)
        shapes.update(gat_shapes)
        for k, v in phase_fused_kernels(device, g_gat).items():
            shapes.setdefault(k, []).extend(v)
        ops = optin_operators(ds, g)
        shapes.update(phase_optin_kernels(device, g, ops))
        phase_gradients(device, g_gat, g)
        phases = phase_optin_train(device, g, ops)
        del ops
        phases.update(phase_forward_only(device, g))
        phases.update(phase_train(tmp))
        phases.update(phase_gat_serve(tmp))
        serve, serve_avg, serve_avg_dev = phase_serve(device, tmp, g)
        phases.update(serve)
        del g, g_gat
        torch.cuda.empty_cache()
        phases.update(phase_curriculum(device, tmp, serve_avg,
                                       serve_avg_dev))

    kernels_line = {"kernels": [
        summarize(label, "cuda", source, replaces,
                  {ph: c[k] for ph, c in phases.items() if c[k]}, shapes[k])
        for k, label, source, replaces in KERNELS]}
    for entry in kernels_line["kernels"]:
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on a main-path phase")
    # the register counts of K7's walks (both slab copies), of the score
    # pass and K5 (both load widths) and of the column sum
    # and of the straggler sum (K3 and K3w without den, K6 with it: three
    # lane counts, two load widths each)
    for (k, *_), entry in zip(KERNELS, kernels_line["kernels"]):
        hook = {"K7f": "FwdScores", "K7bt": "DxScores"}.get(k)
        name = {"K5": "dyn_grad_blocks_kernel", "K7s": "att_scores_kernel",
                "K7sums": "att_sums_kernel",
                "K3": "segmm_spmm_kernel<false", "K3w":
                "segmm_spmm_kernel<false", "K6": "segmm_spmm_kernel<true"
                }.get(k)
        if hook is None and name is None:
            continue
        entry["registers"] = {
            kernel: {"registers": n, "spilled_bytes": spill}
            for _, kernel, n, spill in regs
            if (hook is not None
                and (walk_args(kernel) or (None,) * 4)[3] == hook)
            or (name is not None and kernel.startswith(name))}
        want = {"K7sums": 1, "K3": 6, "K3w": 6, "K6": 6}.get(k, 2)
        check(len(entry["registers"]) == want,
              f"{entry['name']}: no ptxas record of its kernels")
        print(f"{k} registers: {entry['registers']}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
    except Exception:
        traceback.print_exc()
        sys.exit(1)
