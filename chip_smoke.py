#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one GPU and hold
its CUDA kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit; build every native library (one
   ``nvcc`` per CUDA source and the Leiden g++ build, all in parallel);
2. the bench graph (seed 0, 169,344 nodes, 128 features, 40 classes, the
   generator of ``bench.py``), saved as an npz dataset in a temp root;
3. kernels, each against its plain version (rtol 1e-4, atol
   1e-4·max|ref|: f32 sums in another order), with kernel, plain and
   library times and the bound from bytes and operations: on the GCN
   operator K1 (``bsr_spmm_acc``) and K3 (``segmm_spmm``) at F=128 and
   512, and the hybrid SpMM on a small graph against a dense float64
   product; on the GAT (``att_unit``) operator, whose tile split must equal
   the GCN operator's, K4 (``dyn_tiles``) and K4ᵀ (``dyn_tiles_t``) at
   F=128 and 512, K5 (``dyn_grad_blocks``) at F=128 and 512 and K3w
   (``segmm_weighted_raw``) at F=40 and 64;
4. gradients: one GAT and one GCN training step (hidden 512, dropout off,
   the same seed-0 init) with the kernels and then with the plain versions
   patched in; the loss and every parameter gradient within the tolerance
   above, and the launches of the kernel step: GAT K4 ×2, K4ᵀ ×1 (layer
   0's input, the raw features, needs no gradient), K5 ×2; GCN K1 ×3 and
   K3 ×3 (two forward, one backward for layer 1: layer 0 aggregates the
   raw features);
5. train: ``train --baseline`` through the port's CLI on ``cuda``, every
   launch counter at 0 just before each run: GATConv at hidden 512 for 3
   epochs, GCNConv at hidden 512 for 2 epochs, GATConv at hidden 64 for 1
   epoch (its aggregations are 64 wide, so K3w runs); the launches against
   the counts per train step and eval forward that phase 4 confirmed, a
   CSV row with finite losses and a checkpoint per run;
6. serve: ``infer-baseline`` for GATConv at hidden 512 from the checkpoint
   phase 5 saved (K4 ×2 per forward), and for GCNConv at hidden 512 from
   random weights (K1 and K3 ×2 per forward), whose full forward with
   kernels is held against the same forward with the plain versions
   (atol 1e-4);
7. one JSON line with every kernel's numbers (launches summed over the
   CLI phases, per phase beside them), then the ``ok`` line.
"""

from __future__ import annotations

import json
import os
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


def bound(bytes_: float, ops: float) -> tuple:
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_build() -> None:
    from fitgnn_tpu_torch.ops import kernels
    from fitgnn_tpu_torch.partition.community import LEIDEN
    from fitgnn_tpu_torch.utils.build import build
    t0 = time.perf_counter()
    built = build([*kernels.TARGETS, LEIDEN])
    print(f"build: {built} in {time.perf_counter() - t0:.1f} s")
    for t in kernels.TARGETS:
        with open(t.log_path) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    print(f"  {t.name}: {line.strip()}")


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
    nz = b.blocks.nonzero()
    t_rows = b.rows.long()[nz[:, 0]] * 128 + nz[:, 1]
    t_cols = b.cols.long()[nz[:, 0]] * 128 + nz[:, 2]
    a_tiles = torch.sparse_coo_tensor(
        torch.stack([t_rows, t_cols]), b.blocks[nz[:, 0], nz[:, 1], nz[:, 2]],
        (n, n)).coalesce().to_sparse_csr()
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
            torch.cuda.synchronize()
            err3 = compare(f"K3 segmm_spmm F={feat}", k3, init)
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

            # K1's function needs 2 FLOPs per tile non-zero and feature;
            # the kernel's dense tile product does 128·128/occupancy more
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
                ms=cuda_ms(lambda: segmm_spmm(m, x), 20),
                plain_ms=cuda_ms(lambda: segmm_spmm_plain(m, x), 20),
                library_ms=cuda_ms(lib3, 20)))
            for k in ("K1", "K3"):
                s = shapes[k][-1]
                print(f"  {k} F={feat}: kernel_ms={s['ms']:.4f} "
                      f"plain_ms={s['plain_ms']:.4f} "
                      f"library_ms={s['library_ms']:.4f} "
                      f"bound_ms={s['bound_ms']:.4f} ({s['bound_by']})")
    return g, order, shapes


def counters() -> dict:
    """Every kernel wrapper of the path, by the ID of the TPU kernel it
    replaces; each counts its own launches."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import (dyn_grad_blocks,
                                                  dyn_tiles, dyn_tiles_t)
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc
    from fitgnn_tpu_torch.ops.coo_segmm import (segmm_spmm,
                                                segmm_weighted_raw)
    return {"K1": bsr_spmm_acc, "K3": segmm_spmm, "K4": dyn_tiles,
            "K4T": dyn_tiles_t, "K5": dyn_grad_blocks,
            "K3w": segmm_weighted_raw}


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
            # K5's output is every dense tile: 2·F FLOPs per entry
            b5, by5 = bound(k_all * 128 * 128 * 4 + idx_bytes
                            + (uniq_rows + uniq_cols) * 128 * feat * 4,
                            2.0 * k_all * 128 * 128 * feat)
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
                  f"{shapes['K5'][-1]['bmm_pregathered_ms']:.4f} ms")
        for feat in (NUM_CLASSES, 64):
            x = torch.randn((n, feat), generator=gen, device=device)
            print(f"F={feat}:")
            k3w = segmm_weighted_raw(m, w_edge, x)
            p3w = segmm_weighted_raw_plain(m, w_edge, x)
            torch.cuda.synchronize()
            err3w = compare(f"K3w segmm_weighted_raw F={feat}", k3w, p3w)
            compare(f"K3w library torch.sparse.mm F={feat}",
                    torch.sparse.mm(str_csr, x), p3w)
            b3w, by3w = bound((n + 1) * 4 + e * 12 + uniq_senders * feat * 4
                              + n * feat * 4, 2.0 * e * feat)
            shapes["K3w"].append(dict(
                F=feat, **err3w, bound_ms=b3w, bound_by=by3w,
                ms=cuda_ms(lambda: segmm_weighted_raw(m, w_edge, x), 20),
                plain_ms=cuda_ms(lambda: segmm_weighted_raw_plain(
                    m, w_edge, x), 20),
                library_ms=cuda_ms(lambda: torch.sparse.mm(str_csr, x), 20)))
            sh = shapes["K3w"][-1]
            print(f"  K3w F={feat}: kernel_ms={sh['ms']:.4f} "
                  f"plain_ms={sh['plain_ms']:.4f} "
                  f"library_ms={sh['library_ms']:.4f} "
                  f"bound_ms={sh['bound_ms']:.4f} ({sh['bound_by']})")
    return g, shapes


# launches of one training step and one eval forward of a 2-layer model at
# hidden 512, read from the autograd graph and confirmed by phase 4:
# GAT layer 0 aggregates the raw 128-wide features (no dx, so no K4ᵀ),
# layer 1 the 512-wide transformed ones; GCN layer 0 aggregates the raw
# features (no backward), layer 1 its transformed input
STEP = {"GATConv": {"K4": 2, "K4T": 1, "K5": 2},
        "GCNConv": {"K1": 3, "K3": 3}}
EVAL = {"GATConv": {"K4": 2}, "GCNConv": {"K1": 2, "K3": 2}}


def phase_gradients(device, g_gat, g_gcn) -> None:
    """One training step with the kernels, then with the plain versions
    patched in: the loss and every gradient, and the step's launches."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops import bsr_dynamic, coo_segmm
    from fitgnn_tpu_torch.ops import hybrid_spmm as hybrid_mod
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
                          coo_segmm.segmm_weighted_raw_plain)]
    for layer, g in (("GATConv", g_gat), ("GCNConv", g_gcn)):
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

        reset_counts()
        loss_k, grads_k = step()
        expect(read_counts(), STEP[layer], f"{layer} train step")
        reset_counts()
        for patch in plain:
            patch.start()
        try:
            loss_p, grads_p = step()
        finally:
            for patch in plain:
                patch.stop()
        expect(read_counts(), {}, f"{layer} train step, plain versions")
        compare(f"{layer} loss kernels vs plain", loss_k.reshape(1),
                loss_p.reshape(1))
        for k in grads_p:
            compare(f"{layer} grad {k}", grads_k[k], grads_p[k])
        del model, gd, grads_k, grads_p
        torch.cuda.empty_cache()


def run_cli(tmp, argv) -> tuple:
    """Run the port's CLI from ``tmp`` with every counter at 0 just before;
    returns (launches, NodeModel forwards, seconds)."""
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
    epochs), GAT 64 (1 epoch, K3w).  Per epoch one train step and one val
    forward; per run a warm-up and a timed test forward."""
    from fitgnn_tpu_torch.utils.results import TRAIN_NODE_CLS_HEADER

    phases = {}
    runs = (("gat512", "GATConv", HIDDEN, 3),
            ("gcn512", "GCNConv", HIDDEN, 2),
            ("gat64", "GATConv", 64, 1))
    for out_dir, layer, hidden, epochs in runs:
        launches, _, wall = run_cli(tmp, [
            "train", "--baseline", "--layer_name", layer, "--hidden",
            str(hidden), "--runs", "1", "--epochs1", str(epochs),
            "--output_dir", out_dir])
        print(f"train {out_dir}: {wall:.1f} s")
        if hidden == HIDDEN:
            want = {k: epochs * (STEP[layer].get(k, 0)
                                 + EVAL[layer].get(k, 0))
                    + 2 * EVAL[layer].get(k, 0)
                    for k in (*STEP[layer], *EVAL[layer])}
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
    launches, forwards, wall = run_cli(tmp, [
        "infer-baseline", "--layer_name", "GATConv", "--hidden",
        str(HIDDEN), "--num_test_samples", "8", "--output_dir", "gat512"])
    print(f"serve GAT: infer-baseline took {wall:.1f} s, {forwards} forwards")
    check(forwards > 0, "no forward ran")
    expect(launches, {"K4": 2 * forwards}, "serve GAT")
    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    row = dict(zip(lines[0].split(","), lines[-1].split(",")))
    check(row["layer_name"] == "GATConv"
          and float(row["avg_inf_time_device"]) > 0,
          f"bad GAT serve row {lines[-1]}")
    print(f"GAT avg_inf_time={row['avg_inf_time']} avg_inf_time_device="
          f"{row['avg_inf_time_device']} acc={row['acc']}")
    return {"serve gat512": launches}


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


def summarize(name, route, source, replaces, launches, per_shape) -> dict:
    """One kernel's line: times and bounds summed over the shapes one step
    or forward launches it at; errors are the worst over those shapes;
    ``launches`` is the sum over the CLI phases, ``launches_by_phase``
    beside it."""
    top = max(per_shape, key=lambda s: s["bound_ms"])
    libs = [s["library_ms"] for s in per_shape]
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "status": "ok",
        "launches": sum(launches.values()), "launches_by_phase": launches,
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "ms": sum(s["ms"] for s in per_shape),
        "plain_ms": sum(s["plain_ms"] for s in per_shape),
        "bound_ms": sum(s["bound_ms"] for s in per_shape),
        "bound_by": top["bound_by"],
        "library_ms": None if None in libs else sum(libs),
        "per_shape": per_shape,
    }


KERNELS = (
    ("K1", "K1 bsr_spmm_acc", "fitgnn_tpu_torch/csrc/bsr_spmm.cu",
     "fitgnn_tpu/ops/pallas/bsr_spmm.py:200"),
    ("K3", "K3 segmm_spmm", "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:187"),
    ("K4", "K4 dyn_tiles (bsr_spmm_dyn forward)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K4T", "K4 dyn_tiles_t (bsr_spmm_dyn dx, transposed)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:68"),
    ("K5", "K5 dyn_grad_blocks (bsr_spmm_dyn dblocks)",
     "fitgnn_tpu_torch/csrc/bsr_dynamic.cu",
     "fitgnn_tpu/ops/pallas/bsr_dynamic.py:122"),
    ("K3w", "K3w segmm_weighted_raw (segmm_weighted_spmm)",
     "fitgnn_tpu_torch/csrc/coo_segmm.cu",
     "fitgnn_tpu/ops/pallas/coo_segmm.py:370"),
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
    phase_build()
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
        phase_gradients(device, g_gat, g)
        phases = phase_train(tmp)
        phases.update(phase_gat_serve(tmp))
        serve, _, _ = phase_serve(device, tmp, g)
        phases.update(serve)

    kernels_line = {"kernels": [
        summarize(label, "cuda", source, replaces,
                  {ph: c[k] for ph, c in phases.items() if c[k]}, shapes[k])
        for k, label, source, replaces in KERNELS]}
    for entry in kernels_line["kernels"]:
        check(entry["launches"] > 0,
              f"{entry['name']} never launched on a CLI phase")
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
