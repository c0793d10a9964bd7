"""Inference-latency benchmarks: FIT-GNN's subgraph serving and the
full-graph baseline.

Per-sample protocol, as in the JAX package: sample test nodes (numpy
``default_rng(seed)``, so the same nodes), run one forward per sampled
node — of the node's own subgraph (``node_inference_benchmark``, the
paper's headline) or of the full graph (``baseline_inference_benchmark``)
— to the synchronize, and report the mean wall-clock time of those
forwards (the first excluded as warm-up when there are several) with the
loss and accuracy at the sampled nodes.

``avg_inf_time_device`` is the device time of one forward: on the GPU,
CUDA events around ``DEVICE_ITERS`` back-to-back forwards after a
warm-up forward, divided by their count; on the CPU the same loop timed
with ``perf_counter``.  The subgraph benchmark takes it on the first
subgraph, as the JAX package does (one padded shape serves them all).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch import nn

from fitgnn_tpu_torch.graph.container import Graph, SubgraphBatch

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


def _report(nodes, times, losses, correct, classify, dev_time):
    n = max(len(nodes), 1)
    return InferenceReport(
        num_test_samples=len(nodes),
        avg_inf_time=float(np.mean(times[1:]) if len(times) > 1
                           else np.mean(times)),
        avg_loss=float(np.mean(losses)) if losses else 0.0,
        acc=correct / n if classify else 0.0,
        avg_inf_time_device=float(dev_time))


def _score(row: np.ndarray, label, classify: bool, losses: list) -> int:
    """Append the sample's loss; 1 when it is classified right."""
    if classify:
        losses.append(-row[int(label)])
        return int(row.argmax() == label)
    losses.append(abs(float(row[0]) - float(label)))
    return 0


def node_inference_benchmark(
    model: nn.Module, batch: SubgraphBatch, parent: np.ndarray,
    test_mask: np.ndarray, y: np.ndarray, num_samples: int = 100,
    classify: bool = True, seed: int = 0,
) -> InferenceReport:
    """One forward of each sampled test node's own subgraph (metanode
    ``parent[node]``), timed to the synchronize.

    ``model`` and ``batch`` lie on the device to time; ``parent``,
    ``test_mask`` and ``y`` are host arrays over the original nodes."""
    nodes = _sample_nodes(np.asarray(test_mask, dtype=bool), num_samples,
                          seed)
    sub_of_node = np.asarray(parent)[nodes]          # metanode == subgraph
    orig = batch.orig_idx.cpu().numpy()
    dev = batch.x.device
    model.eval()
    times, losses, correct = [], [], 0
    with torch.inference_mode():
        g0 = batch.subgraph(0)
        model(g0.x, g0)
        _sync(dev)
        dev_time = device_seconds_per_forward(model, g0)
        for node, s in zip(nodes, sub_of_node):
            g = batch.subgraph(int(s))
            t0 = time.perf_counter()
            out = model(g.x, g)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            local = int(np.where(orig[int(s)] == node)[0][0])
            correct += _score(out[local].cpu().numpy(), y[node], classify,
                              losses)
    return _report(nodes, times, losses, correct, classify, dev_time)


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
            correct += _score(out[int(node)].cpu().numpy(), y[node],
                              classify, losses)
    return _report(nodes, times, losses, correct, classify, dev_time)
