"""Inference-latency benchmark of the full-graph baseline.

Per-sample protocol, as in the JAX package: sample test nodes, run one
full-graph forward per sampled node, and report the mean wall-clock time
of those forwards (the first excluded as warm-up when there are several)
with the loss and accuracy at the sampled nodes.

``avg_inf_time_device`` is the device time of one forward: on the GPU,
CUDA events around ``DEVICE_ITERS`` back-to-back forwards after a
warm-up forward, divided by their count; on the CPU the same loop timed
with ``perf_counter``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from fitgnn_tpu_torch.graph.container import Graph

DEVICE_ITERS = 16


@dataclasses.dataclass
class InferenceReport:
    num_test_samples: int
    avg_inf_time: float        # seconds per sampled forward (wall-clock)
    avg_loss: float
    acc: float
    avg_inf_time_device: float = 0.0   # device seconds per forward


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_seconds_per_forward(model: nn.Module, g: Graph,
                               iters: int = DEVICE_ITERS) -> float:
    """Device time of one forward, after one warm-up forward."""
    model(g.x, g)
    dev = g.x.device
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(iters):
            model(g.x, g)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        model(g.x, g)
    return (time.perf_counter() - t0) / iters


def _sample_nodes(mask: np.ndarray, num_samples: int, seed: int) -> np.ndarray:
    idx = np.where(mask)[0]
    rng = np.random.default_rng(seed)
    if num_samples > len(idx):
        return rng.choice(idx, size=num_samples, replace=True)
    if num_samples == len(idx):
        return idx
    return rng.choice(idx, size=num_samples, replace=False)


def baseline_inference_benchmark(
    model: nn.Module, g: Graph, test_mask: np.ndarray, y: np.ndarray,
    num_samples: int = 100, classify: bool = True, seed: int = 0,
) -> InferenceReport:
    """Full-graph forward per sampled node (the baseline protocol).

    ``model`` and ``g`` lie on the device to time; ``test_mask`` and ``y``
    are host arrays in ``g``'s node order."""
    nodes = _sample_nodes(np.asarray(test_mask, dtype=bool), num_samples,
                          seed)
    dev = g.x.device
    model.eval()
    times, losses, correct = [], [], 0
    with torch.inference_mode():
        model(g.x, g)
        _sync(dev)
        dev_time = device_seconds_per_forward(model, g)
        for node in nodes:
            t0 = time.perf_counter()
            out = model(g.x, g)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            row = out[int(node)].cpu().numpy()
            if classify:
                losses.append(-row[int(y[node])])
                correct += int(row.argmax() == y[node])
            else:
                losses.append(abs(float(row[0]) - float(y[node])))
    n = max(len(nodes), 1)
    return InferenceReport(
        num_test_samples=len(nodes),
        avg_inf_time=float(np.mean(times[1:]) if len(times) > 1
                           else np.mean(times)),
        avg_loss=float(np.mean(losses)) if losses else 0.0,
        acc=correct / n if classify else 0.0,
        avg_inf_time_device=float(dev_time))
