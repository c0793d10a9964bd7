#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one GPU and hold its CUDA
kernels against their plain PyTorch versions.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the result lines):

1. the card's name and power limit; build every native library (one
   ``nvcc`` per CUDA source and the Leiden g++ build, all in parallel);
2. the bench graph (seed 0, 169,344 nodes, 128 features, 40 classes, the
   generator of ``bench.py``), saved as an npz dataset in a temp root;
3. kernels: the hybrid operator from ``build_optimized_graph``; K1
   (``bsr_spmm_acc``) and K3 (``segmm_spmm``) at F=128 and F=512, f32,
   against their plain versions (rtol 1e-4, atol 1e-4·max|ref|: f32 sums
   in another order), with kernel, plain and library (cuSPARSE through
   ``torch.sparse``) times and the bound from bytes and operations; and
   the hybrid SpMM on a small graph against a dense float64 product;
4. serve: ``infer-baseline`` through the port's CLI on ``cuda`` at hidden
   512, with every launch counter at 0 just before; the CSV row, two K1
   and two K3 launches per forward, and the full forward with kernels
   against the same forward with the plain versions (atol 1e-4);
5. one JSON line with every kernel's numbers, then the ``ok`` line.
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


def phase_serve(device, tmp, g) -> tuple:
    from fitgnn_tpu_torch.cli.main import main as cli_main
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops import hybrid_spmm as hybrid_mod
    from fitgnn_tpu_torch.ops.bsr_spmm import bsr_spmm_acc, bsr_spmm_acc_plain
    from fitgnn_tpu_torch.ops.coo_segmm import segmm_spmm, segmm_spmm_plain
    from fitgnn_tpu_torch.utils.results import INFERENCE_HEADER

    forwards = [0]

    def count_forward(module, args, output):
        if isinstance(module, NodeModel):
            forwards[0] += 1

    hook = torch.nn.modules.module.register_module_forward_hook(
        count_forward)
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        bsr_spmm_acc.launches = 0
        segmm_spmm.launches = 0
        t0 = time.perf_counter()
        rc = cli_main(["infer-baseline", "--dataset", "bench",
                       "--data_root", os.path.join(tmp, "dataset"),
                       "--hidden", str(HIDDEN), "--num_test_samples", "8",
                       "--experiment", "random", "--device", "cuda"])
        launches = {"K1": bsr_spmm_acc.launches, "K3": segmm_spmm.launches}
        wall = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        hook.remove()
    check(rc == 0, f"infer-baseline returned {rc}")
    print(f"serve: infer-baseline took {wall:.1f} s, {forwards[0]} forwards, "
          f"launches {launches}")
    check(forwards[0] > 0, "no forward ran")
    for k, v in launches.items():
        check(v == 2 * forwards[0], f"{k}: {v} launches for {forwards[0]} "
              "forwards (expected 2 per forward)")

    with open(os.path.join(tmp, "inference_results", "node_cls.csv")) as f:
        lines = f.read().splitlines()
    check(len(lines) == 2 and lines[0] == INFERENCE_HEADER,
          f"CSV not written under INFERENCE_HEADER: {lines[:2]}")
    row = dict(zip(lines[0].split(","), lines[1].split(",")))
    avg, avg_dev = float(row["avg_inf_time"]), float(row["avg_inf_time_device"])
    check(np.isfinite(avg) and avg > 0 and np.isfinite(avg_dev)
          and avg_dev > 0, f"bad timings in CSV row {lines[1]}")
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
    return launches, avg, avg_dev


def summarize(name, route, source, replaces, launches, per_shape) -> dict:
    """One kernel's line: times and bounds summed over the shapes one
    forward launches it at; errors are the worst over those shapes."""
    top = max(per_shape, key=lambda s: s["bound_ms"])
    return {
        "name": name, "route": route, "source": source,
        "replaces": replaces, "status": "ok", "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in per_shape),
        "ms": sum(s["ms"] for s in per_shape),
        "plain_ms": sum(s["plain_ms"] for s in per_shape),
        "bound_ms": sum(s["bound_ms"] for s in per_shape),
        "bound_by": top["bound_by"],
        "library_ms": sum(s["library_ms"] for s in per_shape),
        "per_shape": per_shape,
    }


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
        launches, _, _ = phase_serve(device, tmp, g)

    kernels_line = {"kernels": [
        summarize("K1 bsr_spmm_acc", "cuda",
                  "fitgnn_tpu_torch/csrc/bsr_spmm.cu",
                  "fitgnn_tpu/ops/pallas/bsr_spmm.py:200", launches["K1"],
                  shapes["K1"]),
        summarize("K3 segmm_spmm", "cuda",
                  "fitgnn_tpu_torch/csrc/coo_segmm.cu",
                  "fitgnn_tpu/ops/pallas/coo_segmm.py:187", launches["K3"],
                  shapes["K3"]),
    ]}
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
