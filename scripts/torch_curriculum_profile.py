#!/usr/bin/env python3
"""Where the time of the FIT-GNN curriculum's phases goes, on one GPU.

    python3 scripts/torch_curriculum_profile.py      # from the repository root

Partitions the bench graph of ``chip_smoke.py`` (169,344 nodes, 128
features, 40 classes, seed 0) as ``train --experiment random`` does
(variation_neighborhoods, ratio 0.5, plain node mode), then, with the
seed-0 ``NodeModel`` at hidden 512 (2 layers, dropout 0.5, f32), times and
profiles:

* Gc: one GCN and one GAT ``gc_train_step`` and ``gc_eval_step`` (the val
  forward) on the Leiden-reordered Gc with its hybrid operator, as
  ``train`` builds it;
* Gs: one GCN ``gs_train_step_gd`` and ``gs_eval_step`` over every
  subgraph, and one MB epoch (``gs_train_epoch_mb``, 128 subgraphs a
  chunk), with the peak device memory of each;
* serve: one GCN eval forward of one subgraph, what ``infer`` times per
  sampled node, on the card and on the host clock.

The serve forward and the Gs eval are measured a second time with the
dense adjacency built by ``index_put_(…, accumulate=True)``
(``index_put_adjacency`` below; it sorts its indices first on the GPU)
in place of ``ops/spmm.py``'s one ``scatter_add_``, both in this call.

Each item prints its time from CUDA events (warm-up first), its device
time per call by profiler group, its kernel launches per call and the
device's idle share over the profiled window (1 - summed kernel time /
window on the host clock, ended by a synchronize); then one JSON line.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from chip_smoke import HIDDEN, NUM_CLASSES, NUM_FEATURES, make_graph  # noqa
from torch_train_profile import _device_us, _group  # noqa

ROWS_WALK = {"GCNConv": None, "GATConv": "K4 dyn_tiles"}


def index_put_adjacency(values, senders, receivers, num_nodes, dtype):
    """The dense adjacency through ``index_put_`` with ``accumulate``: the
    alternative to ``ops.spmm.dense_adjacency``'s ``scatter_add_``."""
    lead = senders.shape[:-1]
    adj = torch.zeros(lead + (num_nodes, num_nodes), dtype=dtype,
                      device=senders.device)
    idx = (receivers.long(), senders.long())
    if lead:
        b = torch.arange(lead[0], device=senders.device)[:, None].expand_as(
            senders)
        idx = (b,) + idx
    return adj.index_put_(idx, values.to(dtype), accumulate=True)


def measure(label: str, fn, iters: int, profiled: int,
            rows_walk=None, top: int = 0) -> dict:
    """``fn`` timed by CUDA events over ``iters`` calls after 3 warm-ups,
    then profiled over ``profiled`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    call_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(profiled):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    groups, launches, kernels = {}, 0, []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        launches += evt.count
        kernels.append((evt.count / profiled, us / 1e3 / profiled, evt.key))
        k = _group(evt.key, rows_walk)
        groups[k] = groups.get(k, 0.0) + us / 1e3 / profiled
    busy = sum(groups.values())
    out = {"item": label, "ms": call_ms, "host_ms": host_ms,
           "device_busy_ms": busy,
           "idle_share": 1.0 - busy * profiled / window_ms,
           "launches": launches / profiled,
           "groups_ms": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}
    print(f"{label}: {call_ms:.4f} ms (CUDA events), host {host_ms:.4f} ms, "
          f"device busy {busy:.4f} ms, idle {out['idle_share']:.1%}, "
          f"{out['launches']:.1f} launches a call")
    for k, v in out["groups_ms"].items():
        print(f"    {v:9.4f} ms  {k}")
    if top:
        print("    launches a call by kernel:")
        for count, ms, key in sorted(kernels, reverse=True)[:top]:
            print(f"    x{count:5.1f} {ms:8.4f} ms  {key[:100]}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from fitgnn_tpu_torch.data.splits import splits_classification
    from fitgnn_tpu_torch.graph.optimize import optimize_coarse
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
    from fitgnn_tpu_torch.train import steps
    from fitgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    print(smi)
    x, s, r, y, _ = make_graph()
    tr, va, te = splits_classification(y, NUM_CLASSES, "random", seed=0)
    t0 = time.perf_counter()
    part = coarsen_and_partition(x, s, r, y, num_classes=NUM_CLASSES,
                                 train_mask=tr, val_mask=va, test_mask=te)
    print(f"partition: {time.perf_counter() - t0:.2f} s host")
    batch = part.subgraphs.to(dev)
    results = []

    def model_for(layer):
        m = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
        m = m.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
        return (m, steps.adam_l2(m.parameters(), 0.01, 5e-4),
                torch.Generator(device=dev).manual_seed(0))

    for layer in ("GCNConv", "GATConv"):
        t0 = time.perf_counter()
        coarse = optimize_coarse(part.coarse, layer_name=layer,
                                 seed=0).to(dev)
        print(f"optimize_coarse {layer}: {time.perf_counter() - t0:.2f} s "
              f"host, {coarse.graph.aux.bsr.nnz_blocks} tiles, "
              f"{coarse.graph.aux.num_coo_edges} stragglers")
        model, opt, gen = model_for(layer)
        g = coarse.graph
        results.append(measure(
            f"Gc {layer} train step",
            lambda: steps.gc_train_step(model, opt, g, coarse.y_train,
                                        coarse.train_mask, gen,
                                        "classification"),
            10, 5, ROWS_WALK[layer]))
        results.append(measure(
            f"Gc {layer} eval forward",
            lambda: steps.gc_eval_step(model, g, coarse.y_val,
                                       coarse.val_mask, "classification"),
            10, 5, ROWS_WALK[layer]))
        del coarse, g, model, opt
        torch.cuda.empty_cache()

    from fitgnn_tpu_torch.ops import spmm as spmm_mod

    model, opt, gen = model_for("GCNConv")
    for label, fn in (
            ("Gs GCN GD step", lambda: steps.gs_train_step_gd(
                model, opt, batch, gen, "classification")),
            ("Gs GCN eval", lambda: steps.gs_eval_step(
                model, batch, "classification", "test"))):
        torch.cuda.reset_peak_memory_stats()
        out = measure(label, fn, 5, 3)
        out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"    peak device memory {out['peak_memory_gib']:.2f} GiB")
        results.append(out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    steps.gs_train_epoch_mb(model, opt, batch, gen, "classification",
                            batch_size=128)
    torch.cuda.synchronize()
    mb_s = time.perf_counter() - t0
    print(f"Gs GCN MB epoch (batch 128): {mb_s:.3f} s host")
    results.append({"item": "Gs GCN MB epoch", "s": mb_s,
                    "chunks": -(-batch.num_subgraphs // 128)})

    model.eval()
    g0 = batch.subgraph(0)
    committed = spmm_mod.dense_adjacency
    for form, adjacency in (("scatter_add_", committed),
                            ("index_put_", index_put_adjacency)):
        spmm_mod.dense_adjacency = adjacency
        try:
            with torch.inference_mode():
                results.append(measure(
                    f"serve GCN one subgraph forward ({form} adjacency)",
                    lambda: model(g0.x, g0), 200, 20, top=12))
            results.append(measure(
                f"Gs GCN eval ({form} adjacency)",
                lambda: steps.gs_eval_step(model, batch, "classification",
                                           "test"), 5, 3, top=6))
        finally:
            spmm_mod.dense_adjacency = committed
    print(json.dumps({"device": smi, "subgraphs": batch.num_subgraphs,
                      "n_pad": batch.num_nodes_padded,
                      "e_pad": batch.senders.shape[1],
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
