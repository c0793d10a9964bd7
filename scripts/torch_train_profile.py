#!/usr/bin/env python3
"""Where the time of one ``train --baseline`` step goes, on one GPU.

    python3 scripts/torch_train_profile.py      # from the repository root
    python3 scripts/torch_train_profile.py --collapse-only   # the collapse
    python3 scripts/torch_train_profile.py --block 256   # tiles of edge 256
    python3 scripts/torch_train_profile.py --hier   # the hierarchical layer

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
``use_diag`` (K8), ``tile_group=2`` (K9) and ``use_rowwalk`` (K10); then
SAGE and GIN on their own operators (``mean_nonself`` and ``sum_nonself``
weights: K3 then K1, as GCN), and GCN, SAGE and GIN pre-aggregated
(``first_layer_preaggregated``, layer 0's input from
``preaggregate_input`` once, as ``train --baseline --preaggregate``); then
the cluster collapse at threshold 192: GCN under ``cluster_agg`` 2048, and
with ``cluster_agg_exact`` 4096, GAT under ``cluster_att`` 2048 on its
default path and under ``FITGNN_GAT_FUSED_TILES=1 FITGNN_GAT_SEGMM_DEN=1``,
and SAGE and GIN under ``cluster_agg`` 2048 (the static collapse's
product runs in cuBLAS, so it lands in the dense group; each static row
also times the collapse term alone, ``_cluster_static_term`` forward at
F=128 and forward and backward at F=512, as a step runs it).
``--block E`` profiles instead GCN with K11 on tiles of edge E (a
multiple of 128; ``build_hybrid(block=E)`` on the reordered graph, as
``bench.py``'s ``FITGNN_BENCH_BLOCK`` composes it and ``chip_smoke.py``'s
phase 14 builds it): at threshold 48 (K1), at 48 with ``tile_group=2``
(K9) and at 192 with ``use_diag`` (K8, then K1), then GAT on its default
two-stage path on the ``att_unit`` operator at E and threshold 48 (K4,
K4ᵀ and K5 at E; above 128 K4 and K4ᵀ walk the live quadrants of the
plan's occupancy words), as ``chip_smoke.py``'s phase 15 builds it, and
on the same operator under ``FITGNN_GAT_FUSED_TILES=1
FITGNN_GAT_SEGMM_DEN=1`` (K7 at E, K6; above 128 K7f walks the live
quadrants and K7s runs a CTA a live quadrant), phase 16's fused step; the
walks at E take the tiles as 128-wide quadrants and land in the same
groups.  ``--hier`` profiles instead the hierarchical layer
(``parallel/hierarchical.py``) in a one-rank NCCL world, as
``chip_smoke.py``'s phase 19 builds it (the bench graph in the Leiden
order of ``build_optimized_graph``, ``shard_graph`` and
``build_hier_plan`` at its threshold of 150, dropout off): the
``HierNodeModel``'s ``hier_train_step`` and ``hier_eval_step`` for GCN
and GAT, each beside the single-device ``NodeModel`` on its operator at
threshold 150 (the same seed-0 parameters).  For each configuration it
prints:

* the step's time (``gc_train_step``: forward, masked NLL, backward, Adam)
  from CUDA events over 10 steps after 3 warm-ups, and the eval forward's
  (``gc_eval_step``) over 10 after 3;
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

import numpy as np
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

    def eval_():
        steps.gc_eval_step(model, g, g.y, g.train_mask, "classification")

    return {"layer": layer, **profile_fns(label, step, eval_, rows_walk)}


def profile_fns(label: str, step, eval_, rows_walk: str | None) -> dict:
    """Times ``step`` and ``eval_`` by CUDA events and profiles ``step``;
    ``rows_walk`` is the label of the one rows-walk wrapper it launches
    (None: none)."""
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

    for _ in range(3):
        eval_()
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        eval_()
    end.record()
    end.synchronize()
    eval_ms = start.elapsed_time(end) / 10

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
    print(f"{label}: step (CUDA events, 10 steps): {step_ms:.4f} ms; eval "
          f"forward {eval_ms:.4f} ms")
    print("device time per step by kernel (profiler):")
    for us, count, key in rows[:25]:
        print(f"  {us / 1e3 / PROFILED:9.4f} ms  x{count / PROFILED:5.1f}  "
              f"{key[:90]}")
    busy = sum(groups.values())
    return {
        "config": label, "step_ms": step_ms, "eval_ms": eval_ms,
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
    from fitgnn_tpu_torch.models.models import preaggregate_input
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    x, s, r, y, train = make_graph()
    if "--collapse-only" in sys.argv[1:]:
        profile_collapse(x, s, r, y, train, dev)
        return 0
    if "--block" in sys.argv[1:]:
        profile_block(int(sys.argv[sys.argv.index("--block") + 1]), x, s, r,
                      y, train, dev)
        return 0
    if "--hier" in sys.argv[1:]:
        profile_hier(x, s, r, y, train, dev)
        return 0
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
    configs = [("GCNConv", g, {}, K1, "GCNConv"),
               ("GCNConv K11", g, k11, K1, "GCNConv")]
    for name, kw, walk in (("diag", dict(use_diag=True), K1),
                           ("tile_group=2", dict(tile_group=2),
                            "K9 bsr_spmm_grouped")):
        g2, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                      layer_name="GCNConv", seed=0, **kw)
        configs.append((f"GCNConv K11 {name}", g2, k11, walk, "GCNConv"))
    # build_optimized_graph has no use_rowwalk: the operator is built on
    # the reordered graph, as bench.py builds it
    h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                     g.edge_weight.numpy(), g.num_nodes_padded,
                     min_block_edges=48, use_segmm=True, use_rowwalk=True)
    configs.append(("GCNConv K11 rowwalk", g._replace(aux=h), k11,
                    "K10 bsr_spmm_rowwalk", "GCNConv"))
    own = {"GCNConv": g}
    for layer in ("SAGEConv", "GINConv"):
        own[layer], _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                              layer_name=layer, seed=0)
        configs.append((layer, own[layer], {}, K1, layer))
    for label, graph, kw, walk, layer in configs:
        gd = graph.to(dev)
        out = profile_step(layer, gd, dev, label, walk, **kw)
        print(json.dumps({"model": kw, **out}))
        del gd
        torch.cuda.empty_cache()
    for layer, graph in own.items():
        gd = graph.to(dev)
        with torch.no_grad():
            gd = gd._replace(x=preaggregate_input(gd, layer))
        out = profile_step(layer, gd, dev, f"{layer} preaggregated", K1,
                           first_layer_preaggregated=True)
        print(json.dumps({"model": {"first_layer_preaggregated": True},
                          **out}))
        del gd
        torch.cuda.empty_cache()
    del own, configs
    profile_collapse(x, s, r, y, train, dev)
    return 0


def profile_hier(x, s, r, y, train, dev) -> None:
    """GCN and GAT through the hierarchical layer at one rank (NCCL, H = D
    = 1) and through the single-device path, both at threshold 150."""
    import tempfile
    import torch.distributed as dist
    from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                                 _operator_weights,
                                                 build_optimized_graph)
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid
    from fitgnn_tpu_torch.parallel import (HierNodeModel, build_hier_plan,
                                           hier_eval_step, hier_train_step,
                                           initialize_distributed,
                                           make_hier_mesh, shard_graph)
    from fitgnn_tpu_torch.train import steps

    g, order = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                     layer_name="GCNConv", seed=0)
    s_np = g.senders.numpy().astype(np.int64)
    r_np = g.receivers.numpy().astype(np.int64)
    n_pad = g.num_nodes_padded
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed(dev, f"file://{tmp}/store", 0, 1)
        try:
            mesh = make_hier_mesh(1, 1)
            for layer in ("GCNConv", "GATConv"):
                sem = _LAYER_SEMANTICS[layer]
                sg = shard_graph(x, s, r, y, 1, train_mask=train,
                                 order=order, semantics=sem)
                n_loc = sg.nodes_per_shard
                rp = build_hier_plan(
                    sg.senders, sg.receivers, sg.edge_weight, 1, 1, n_loc,
                    np.arange(n_loc) // 128,
                    interior_semantics=sem).local(mesh, dev)
                shard = sg.local(0, dev)
                gd = g._replace(aux=build_hybrid(
                    s_np, r_np, _operator_weights(
                        s_np, r_np, g.edge_weight.numpy(), n_pad, sem),
                    n_pad, min_block_edges=150, use_segmm=True,
                    semantics=sem, real_nodes=len(x))).to(dev)
                ref = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES,
                                dropout_rate=0.0)
                ref.reset_parameters(torch.Generator().manual_seed(0))
                hier = HierNodeModel(layer, NUM_FEATURES, HIDDEN, 2,
                                     NUM_CLASSES, dropout_rate=0.0)
                hier.load_state_dict(ref.state_dict())
                ref, hier = ref.to(dev), hier.to(dev)
                opt_h = steps.adam_l2(hier.parameters(), 0.01, 5e-4)
                opt_r = steps.adam_l2(ref.parameters(), 0.01, 5e-4)
                walk = K1 if layer == "GCNConv" else None
                runs = (
                    ("hier", lambda: hier_train_step(
                        hier, opt_h, shard.x, shard.y, shard.train_mask,
                        rp, None, "classification"),
                     lambda: hier_eval_step(
                        hier, shard.x, shard.y, shard.train_mask, rp,
                        "classification"), walk),
                    ("single-device", lambda: steps.gc_train_step(
                        ref, opt_r, gd, gd.y, gd.train_mask, None,
                        "classification"),
                     lambda: steps.gc_eval_step(
                        ref, gd, gd.y, gd.train_mask, "classification"),
                     walk if layer == "GCNConv" else "K4 dyn_tiles"))
                for name, step, eval_, rows_walk in runs:
                    out = profile_fns(f"{layer} {name} threshold 150",
                                      step, eval_, rows_walk)
                    print(json.dumps({"layer": layer, "path": name,
                                      "dropout": 0.0, **out}))
                del rp, shard, gd, ref, hier, opt_h, opt_r, runs
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()


# the rows at another tile edge: (label, build_hybrid's options, the
# rows-walk label)
BLOCK_CONFIGS = (("threshold 48", dict(min_block_edges=48), K1),
                 ("threshold 48 tile_group=2",
                  dict(min_block_edges=48, tile_group=2),
                  "K9 bsr_spmm_grouped"),
                 ("threshold 192 use_diag",
                  dict(min_block_edges=192, use_diag=True), K1))


def profile_block(block: int, x, s, r, y, train, dev) -> None:
    """GCN with K11 on each of ``BLOCK_CONFIGS``' operators at tile edge
    ``block``, built on the reordered graph of ``build_optimized_graph``,
    then GAT (dropout 0.5, the default switches) on the ``att_unit``
    operator at ``block`` and threshold 48 of its own reordered graph."""
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GCNConv", seed=0)
    for name, kw, walk in BLOCK_CONFIGS:
        h = build_hybrid(g.senders.numpy(), g.receivers.numpy(),
                         g.edge_weight.numpy(), g.num_nodes_padded,
                         block=block, use_segmm=True, **kw)
        info = {"block": block, "operator": kw, "tiles": h.bsr.nnz_blocks,
                "diag_blocks": 0 if h.diag_blocks is None
                else h.diag_blocks.shape[0],
                "straggler_edges": h.num_coo_edges}
        gd = g._replace(aux=h).to(dev)
        out = profile_step("GCNConv", gd, dev,
                           f"GCNConv K11 block {block} {name}", walk,
                           fused_dropout=True, bit_dropout=False)
        print(json.dumps({**info, **out}))
        del gd, h
        torch.cuda.empty_cache()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name="GATConv", seed=0)
    h = build_hybrid(g.senders.numpy().astype(np.int64),
                     g.receivers.numpy().astype(np.int64),
                     (g.edge_weight.numpy() > 0).astype(np.float32),
                     g.num_nodes_padded, min_block_edges=48, block=block,
                     use_segmm=True, semantics="att_unit",
                     real_nodes=len(x))
    info = {"block": block, "operator": {"min_block_edges": 48,
                                         "semantics": "att_unit"},
            "tiles": h.bsr.nnz_blocks, "straggler_edges": h.num_coo_edges}
    gd = g._replace(aux=h).to(dev)
    out = profile_step("GATConv", gd, dev,
                       f"GATConv block {block} threshold 48",
                       "K4 dyn_tiles")
    print(json.dumps({**info, **out}))
    torch.cuda.empty_cache()
    # the fused path with K6 on the same operator: K7 at the edge (above
    # 128 K7f on the live quadrants, K7s on its live grid), no rows walk
    # from zero
    with switches(FUSED):
        out = profile_step("GATConv", gd, dev,
                           f"GATConv block {block} threshold 48 fused + K6",
                           None)
    print(json.dumps({**info, "switches": FUSED, **out}))


# the collapse rows: (label, layer, build_optimized_graph's collapse, the
# switches, the rows-walk label)
COLLAPSE = (
    ("GCNConv cluster_agg 2048", "GCNConv", dict(cluster_agg=2048), {}, K1),
    ("GCNConv cluster_agg 2048 exact 4096", "GCNConv",
     dict(cluster_agg=2048, cluster_agg_exact=4096), {}, K1),
    ("GATConv cluster_att 2048", "GATConv", dict(cluster_att=2048), {},
     "K4 dyn_tiles"),
    ("GATConv cluster_att 2048 fused", "GATConv", dict(cluster_att=2048),
     FUSED, None),
    ("SAGEConv cluster_agg 2048", "SAGEConv", dict(cluster_agg=2048), {}, K1),
    ("GINConv cluster_agg 2048", "GINConv", dict(cluster_agg=2048), {}, K1))
COLLAPSE_THRESHOLD = 192


def collapse_term_ms(h, dev) -> float:
    """The static collapse term alone, as a step runs it: forward at F=128
    (layer 0), forward and backward at F=512 (layer 1); CUDA events over
    10 after 3."""
    from fitgnn_tpu_torch.ops.hybrid_spmm import _cluster_static_term

    gen = torch.Generator(device=dev).manual_seed(1)
    x0 = torch.randn((h.num_nodes, NUM_FEATURES), generator=gen, device=dev)
    x1 = torch.randn((h.num_nodes, HIDDEN), generator=gen, device=dev,
                     requires_grad=True)
    g1 = torch.randn((h.num_nodes, HIDDEN), generator=gen, device=dev)

    def run():
        _cluster_static_term(h, x0)
        _cluster_static_term(h, x1).backward(g1)

    for _ in range(3):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(10):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 10


def profile_collapse(x, s, r, y, train, dev) -> None:
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph

    for label, layer, collapse, env, walk in COLLAPSE:
        g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                     layer_name=layer, seed=0,
                                     min_block_edges=COLLAPSE_THRESHOLD,
                                     **collapse)
        h = g.aux
        cc = h.cluster_count
        info = {"collapse": collapse, "threshold": COLLAPSE_THRESHOLD,
                "n_pad": g.num_nodes_padded, "C": cc.shape[1],
                "tiles": 0 if h.bsr is None else h.bsr.nnz_blocks,
                "straggler_edges": h.num_coo_edges,
                "cluster_entries": int((cc > 0).sum()),
                "table": f"{cc.dtype}, "
                         f"{cc.numel() * cc.element_size() / 2**20:.1f} MiB"}
        gd = g.to(dev)
        with switches(env):
            out = profile_step(layer, gd, dev, label, walk)
        if layer != "GATConv":
            info["collapse_term_ms"] = collapse_term_ms(gd.aux, dev)
        print(json.dumps({"switches": env, **info, **out}))
        del g, gd, h, cc
        torch.cuda.empty_cache()


if __name__ == "__main__":
    sys.exit(main())
