"""Graph-level inference timing: per-graph latency through the Gc view and
through the Gs subgraph-set view, as the JAX package's
``graph_inference_benchmark`` measures it.

Each graph is collated alone and moved to the device before its clock
starts; one forward of it is timed on the host clock to the synchronize
(the first left out of the mean when there are several).
``avg_inf_time_device`` is the device time of one forward
(``device_seconds_per_call``: CUDA events around back-to-back forwards),
taken once for each padded shape and averaged by the number of graphs of
each shape.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from fitgnn_tpu_torch.bench.inference import (InferenceReport, _sync,
                                              device_seconds_per_call)
from fitgnn_tpu_torch.data.graph_level import (GraphLevelBatch, GraphSample,
                                               collate_graph_level)
from fitgnn_tpu_torch.models.models import GraphModel


def _signature(b: GraphLevelBatch) -> tuple:
    """The padded shapes of a single-graph batch."""
    return (tuple(b.gc.x.shape), tuple(b.gc.senders.shape),
            tuple(b.gs.x.shape), tuple(b.gs.senders.shape))


def graph_inference_benchmark(model: GraphModel, samples: List[GraphSample],
                              y: np.ndarray, view: str = "gs",
                              classify: bool = True) -> InferenceReport:
    """Time one single-sample forward per graph in ``view`` ("gs" or "gc")
    on the model's device; ``y`` holds the host labels or targets of
    ``samples``."""
    if view not in ("gs", "gc"):
        raise ValueError(f"view must be 'gs' or 'gc', got {view!r}")
    device = next(model.parameters()).device
    model.eval()

    def forward(b):
        if view == "gc":
            return model(b.gc.x, b.gc, b.gc_graph_ids, 1)
        return model.forward_subgraphs(b.gs, b.gs_graph_ids, 1)

    times, losses, correct = [], [], 0
    dev_times, shape_counts = {}, {}
    with torch.inference_mode():
        for i, smp in enumerate(samples):
            b = collate_graph_level([smp]).to(device)
            sig = _signature(b)
            if sig not in dev_times:
                dev_times[sig] = device_seconds_per_call(
                    lambda: forward(b), device)
            shape_counts[sig] = shape_counts.get(sig, 0) + 1
            t0 = time.perf_counter()
            out = forward(b)
            _sync(device)
            times.append(time.perf_counter() - t0)
            row = out[0].cpu().numpy()
            if classify:
                losses.append(-np.log(max(row[int(y[i])], 1e-12)))
                correct += int(row.argmax() == y[i])
            else:
                losses.append(abs(float(row[0]) - float(y[i])))
    n = max(len(samples), 1)
    dev_avg = (sum(dev_times[s] * c for s, c in shape_counts.items())
               / max(sum(shape_counts.values()), 1))
    return InferenceReport(
        num_test_samples=len(samples),
        avg_inf_time=float(np.mean(times[1:]) if len(times) > 1
                           else np.mean(times)),
        avg_loss=float(np.mean(losses)),
        acc=correct / n if classify else 0.0,
        avg_inf_time_device=float(dev_avg))
