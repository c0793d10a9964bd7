#!/usr/bin/env python3
"""Where the time of one ``train --baseline`` step goes, on one GPU.

    python3 scripts/torch_train_profile.py      # from the repository root

Builds the bench graph of ``chip_smoke.py`` (169,344 nodes, 128 features,
40 classes, seed 0) through the port's ``build_optimized_graph`` for GCN
and for GAT, and puts the seed-0 ``NodeModel`` (2 layers, hidden 512, f32,
dropout 0.5 from a seeded generator) with ``adam_l2(0.01, 5e-4)`` on the
card: GAT on its default path, under ``FITGNN_GAT_FUSED_TILES=1`` (K7) and
under ``FITGNN_GAT_FUSED_TILES=1 FITGNN_GAT_SEGMM_DEN=1`` (K7 and K6), GAT
at hidden 64 on its default path (its straggler sums take K3w, forward and
``dx``, in both layers: 4 launches a step), then
GCN on its default path, with ``fused_dropout=True, bit_dropout=False``
(K11), and with K11 on the operators of ``build_hybrid``'s tile opt-ins:
``use_diag`` (K8), ``tile_group=2`` (K9) and ``use_rowwalk`` (K10).  For
each it prints:

* the step's time (``gc_train_step``: forward, masked NLL, backward, Adam)
  from CUDA events over 10 steps after 3 warm-ups;
* a ``torch.profiler`` table of device time per kernel over 5 steps,
  grouped into the port's kernels (K1-K11), the dense layers (cuBLAS), the
  optimizer and the rest.  K7f and K7bt's ``dx`` launch the walk under
  their value hooks, ``sparse::walk_kernel<…, att::FwdScores>`` and
  ``<…, att::DxScores>``; K7's score gradients launch
  ``att_scores_kernel`` (K7s: each tile's row and column partials of
  ``d_raw``) and ``att_sums_kernel`` (K7sums: ``dsdst`` and ``dssrc``).
  K8 launches the walk over the diagonal blocks,
  ``sparse::walk_kernel<…, true, sparse::Plain>`` (DIAG), in both
  orientations.  K1 alone launches the other rows walk from ``init``,
  ``sparse::walk_kernel<false, true, …, false, sparse::Plain>``.  K2, K4,
  K9 and K10 all launch the rows walk from zero,
  ``sparse::walk_kernel<false, false, …, false, sparse::Plain>``, so that
  kernel is labelled by the configuration (K4 in the default GAT run, K9
  on ``tile_group=2``, K10 on ``use_rowwalk``).  The launch counters
  must show that the profiled steps launched the one rows-walk wrapper
  the configuration expects and no other (K1 in the default GCN runs and
  on ``use_diag``);
* the device's idle share over the profiled window: 1 - (summed kernel
  time) / (window time on the host clock, ended by a synchronize).
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (FUSED, FUSED_ONLY, HIDDEN, NUM_CLASSES,  # noqa
                        NUM_FEATURES, make_graph, switches, walk_args)

PROFILED = 5


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


K1 = "K1 bsr_spmm_acc"
# the score gradients: each tile's row and column partials of d_raw in one
# pass, then their sums (dsdst, dssrc)
K7S = "K7s att_bwd_scores"
K7SUMS = "K7sums att_sums"


def _rows_walk_users() -> dict:
    """The wrappers that launch ``sparse::walk_kernel<false, …>``, by the
    label of their profile group."""
    from fitgnn_tpu_torch.ops.bsr_dynamic import dyn_tiles
    from fitgnn_tpu_torch.ops.bsr_spmm import (bsr_spmm_acc, bsr_spmm_fwd,
                                               bsr_spmm_grouped,
                                               bsr_spmm_rowwalk)
    return {K1: bsr_spmm_acc, "K2 bsr_spmm_fwd": bsr_spmm_fwd,
            "K4 dyn_tiles": dyn_tiles, "K9 bsr_spmm_grouped": bsr_spmm_grouped,
            "K10 bsr_spmm_rowwalk": bsr_spmm_rowwalk}


def _group(name: str, rows_walk: str | None) -> str:
    """The profile group of kernel ``name``; ``rows_walk`` labels the rows
    walk from zero, which several wrappers share."""
    walk = walk_args(name)
    if walk is not None:
        trans, init, diag, hook = walk
        # K7's walks carry their own value hook, whatever the configuration
        if hook == "FwdScores":
            return "K7f att_fwd"
        if hook == "DxScores":
            return "K7bt att_bwd_t (dx)"
        if diag:
            return "K8 diag_spmm"
        if trans:
            return "K4T dyn_tiles_t"
        if init:
            return K1
        if rows_walk in (None, K1):
            raise RuntimeError(f"{name} ran in a configuration that expects "
                               "no rows walk from zero")
        return rows_walk
    if "philox_dropout_kernel" in name:
        return "K11 philox_dropout"
    if "att_rowmax_kernel" in name:
        return "K7rm att_rowmax"
    if "att_scores_kernel" in name:
        return K7S
    if "att_sums_kernel" in name:
        return K7SUMS
    # segmm_spmm_kernel<DEN, …>: DEN is K6's den output
    if "segmm_spmm_kernel<true" in name:
        return "K6 segmm_weighted_den_raw"
    if "segmm_spmm" in name:
        return "K3/K3w segmm_spmm"
    if "dyn_grad_blocks" in name:
        return "K5 dyn_grad_blocks"
    if "gemm" in name or "sgemm" in name or "matmul" in name.lower():
        return "dense layers (cuBLAS)"
    if "adam" in name.lower() or "multi_tensor" in name.lower():
        return "optimizer (Adam)"
    if "index" in name.lower() or "scatter" in name.lower() \
            or "gather" in name.lower():
        return "gathers and scatters (index_select, index_add)"
    return "elementwise, reductions, dropout, copies"


def profile_step(layer: str, g, dev, label: str, rows_walk: str | None,
                 hidden: int = HIDDEN, **model_kw) -> dict:
    """Times and profiles one configuration; ``rows_walk`` is the label of
    the one rows-walk wrapper its step launches (None: none)."""
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train import steps

    model = NodeModel(layer, NUM_FEATURES, hidden, 2, NUM_CLASSES,
                      **model_kw)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        steps.gc_train_step(model, opt, g, g.y, g.train_mask, gen,
                            "classification")

    for _ in range(3):
        step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        step()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / 10

    users = _rows_walk_users()
    before = {k: fn.launches for k, fn in users.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    launched = sorted(k for k, fn in users.items()
                      if fn.launches > before[k])
    if launched != ([rows_walk] if rows_walk else []):
        raise RuntimeError(f"{label}: the profiled steps launched the rows "
                           f"walk through {launched}, expected {rows_walk}")

    groups: dict = {}
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((us, evt.count, evt.key))
        k = _group(evt.key, rows_walk)
        groups[k] = groups.get(k, 0.0) + us / 1e3 / PROFILED
    rows.sort(reverse=True)
    print(f"{label}: step (CUDA events, 10 steps): {step_ms:.4f} ms")
    print("device time per step by kernel (profiler):")
    for us, count, key in rows[:25]:
        print(f"  {us / 1e3 / PROFILED:9.4f} ms  x{count / PROFILED:5.1f}  "
              f"{key[:90]}")
    busy = sum(groups.values())
    return {
        "config": label, "layer": layer, "step_ms": step_ms,
        "profiled_window_ms_per_step": window_ms / PROFILED,
        "device_busy_ms_per_step": busy,
        "idle_share": 1.0 - busy * PROFILED / window_ms,
        "groups_ms_per_step": dict(sorted(groups.items(),
                                          key=lambda kv: -kv[1])),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    import subprocess
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    x, s, r, y, train = make_graph()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GATConv", seed=0)
    g = g.to(dev)
    for env in ({}, FUSED_ONLY, FUSED):
        with switches(env):
            # the fused runs take K7f where the default takes K4
            out = profile_step("GATConv", g, dev, f"GATConv {env}",
                               None if env else "K4 dyn_tiles")
        print(json.dumps({"switches": env, **out}))
        torch.cuda.empty_cache()
    out = profile_step("GATConv", g, dev, "GATConv hidden 64",
                       "K4 dyn_tiles", hidden=64)
    print(json.dumps({"switches": {}, "hidden": 64, **out}))
    torch.cuda.empty_cache()
    del g
    k11 = dict(fused_dropout=True, bit_dropout=False)
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GCNConv", seed=0)
    # K1 runs on the default operator and after K8 on use_diag's; the
    # grouped and row-walk layouts add init to K9's or K10's output instead
    configs = [("GCNConv", g, {}, K1), ("GCNConv K11", g, k11, K1)]
    for name, kw, walk in (("diag", dict(use_diag=True), K1),
                           ("tile_group=2", dict(tile_group=2),
                            "K9 bsr_spmm_grouped")):
        g2, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                      layer_name="GCNConv", seed=0, **kw)
        configs.append((f"GCNConv K11 {name}", g2, k11, walk))
    # build_optimized_graph has no use_rowwalk: the operator is built on
    # the reordered graph, as bench.py builds it
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     g.edge_weight.numpy(), g.num_nodes_padded,
                     min_block_edges=48, use_segmm=True, use_rowwalk=True)
    configs.append(("GCNConv K11 rowwalk", g._replace(aux=h), k11,
                    "K10 bsr_spmm_rowwalk"))
    for label, graph, kw, walk in configs:
        gd = graph.to(dev)
        out = profile_step("GCNConv", gd, dev, label, walk, **kw)
        print(json.dumps({"model": kw, **out}))
        del gd
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
