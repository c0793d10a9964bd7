#!/usr/bin/env python3
"""Where the time of one ``infer-baseline`` forward goes, on one GPU.

    python3 scripts/torch_serve_profile.py      # from the repository root

Builds the bench graph of ``chip_smoke.py`` (169,344 nodes, 128 features,
40 classes, seed 0) through the port's ``build_optimized_graph``, puts the
seed-0 GCN ``NodeModel`` (2 layers, hidden 512, f32) on the card and prints:

* the forward's time from CUDA events over 20 forwards after 3 warm-ups;
* a ``torch.profiler`` table of device time per kernel over 10 forwards,
  grouped into K1 (the non-zero walk started from ``init``), K3, the
  dense layers (matmul) and the rest;
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

from chip_smoke import (HIDDEN, NUM_CLASSES, NUM_FEATURES,  # noqa
                        make_graph, walk_args)

PROFILED = 10


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _group(name: str) -> str:
    walk = walk_args(name)
    # the rows walk from init, not over the diagonal, is K1's alone
    if walk == (False, True, False, "Plain"):
        return "K1 bsr_spmm_acc"
    if walk is not None:
        raise RuntimeError(f"{name}: the GCN forward launches no walk but "
                           "K1's")
    if "segmm_spmm" in name:
        return "K3 segmm_spmm"
    if "gemm" in name or "sgemm" in name or "matmul" in name.lower():
        return "dense layers (cuBLAS)"
    return "elementwise, bias, elu, log_softmax, copies"


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from fitgnn_tpu_torch.graph.optimize import build_optimized_graph
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    x, s, r, _, _ = make_graph()
    g, _ = build_optimized_graph(x, s, r, seed=0)
    g = g.to(dev)
    model = NodeModel("GCNConv", NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model = model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    with torch.inference_mode():
        for _ in range(3):
            model(g.x, g)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            model(g.x, g)
        end.record()
        end.synchronize()
        fwd_ms = start.elapsed_time(end) / 20

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(PROFILED):
                model(g.x, g)
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3

    groups: dict = {}
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rows.append((us, evt.count, evt.key))
        k = _group(evt.key)
        groups[k] = groups.get(k, 0.0) + us / 1e3 / PROFILED
    rows.sort(reverse=True)
    print(f"forward (CUDA events, 20 forwards): {fwd_ms:.4f} ms")
    print("device time per forward by kernel (profiler):")
    for us, count, key in rows:
        print(f"  {us / 1e3 / PROFILED:9.4f} ms  x{count / PROFILED:4.1f}  "
              f"{key[:90]}")
    busy = sum(groups.values())
    summary = {
        "forward_ms": fwd_ms,
        "profiled_window_ms_per_forward": window_ms / PROFILED,
        "device_busy_ms_per_forward": busy,
        "idle_share": 1.0 - busy * PROFILED / window_ms,
        "groups_ms_per_forward": groups,
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
