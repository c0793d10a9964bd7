"""``scripts/torch_scaling_bench.py`` on the CPU (gloo ranks) against the
JAX package's ``scripts/scaling_bench.py`` pipeline: at 3,072 nodes,
``--devices 1 2 --steps 1``, one line a P with both steps' times and the
boundary rows, which must equal ``send_mask.sum()`` of the JAX package's
halo plan of the same graph (its generator, Leiden, placement and
sharding)."""

import os
import re
import subprocess
import sys

import numpy as np
import torch

from fitgnn_tpu.data.splits import splits_classification
from fitgnn_tpu.data.synthetic import sbm_graph
from fitgnn_tpu.parallel import build_halo_plan, shard_graph
from fitgnn_tpu.parallel.multihost import placement_by_community
from fitgnn_tpu.partition.community import leiden_communities

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NODES, DEGREE = 3072, 8


def jax_boundary_rows(p):
    """The JAX script's graph and plan at P = ``p``: send_mask.sum()."""
    x, _, _, y = sbm_graph(num_nodes=NODES, num_classes=8, num_features=64,
                           p_in=0.0, p_out=0.0, seed=0)
    rng = np.random.default_rng(0)
    e = NODES * DEGREE // 2
    rcv = rng.integers(0, NODES, e)
    snd = np.where(rng.random(e) < 0.85,
                   rcv // 256 * 256 + rng.integers(0, 256, e),
                   rng.integers(0, NODES, e))
    keep = snd != rcv
    snd, rcv = snd[keep], rcv[keep]
    train, _, _ = splits_classification(y, 8, "ogbn_split", seed=0)
    labels = leiden_communities(snd, rcv, NODES, seed=0)
    order, _ = placement_by_community(labels, p)
    sg = shard_graph(x, snd, rcv, y, p, train_mask=train, order=order)
    plan = build_halo_plan(np.asarray(sg.senders), np.asarray(sg.receivers),
                           np.asarray(sg.edge_weight), p, sg.nodes_per_shard)
    return int(np.asarray(plan.send_mask).sum())


def test_scaling_bench_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_scaling_bench.py"),
         "--device", "cpu", "--nodes", str(NODES), "--devices", "1", "2",
         "--steps", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = {int(m.group(1)): m for m in re.finditer(
        r"^P=(\d+): all-gather +([\d.]+) ms +([\d.]+) Me/s \(eff ([\d.]+),"
        r".*\| halo +([\d.]+) ms +([\d.]+) Me/s \(eff ([\d.]+),.*"
        r" (\d+) boundary rows\)$", out.stdout, re.M)}
    assert sorted(lines) == [1, 2], out.stdout
    for p, m in lines.items():
        assert int(m.group(8)) == jax_boundary_rows(p)
        times = [float(m.group(i)) for i in (2, 3, 5, 6)]
        assert all(t > 0 for t in times), m.group(0)
    assert int(lines[1].group(8)) == 0 < int(lines[2].group(8))
    # the efficiencies are against the first P
    assert lines[1].group(4) == lines[1].group(7) == "1.00"
