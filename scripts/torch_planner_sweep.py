#!/usr/bin/env python3
"""Fit the ingest planner's rates (``fitgnn_tpu_torch/graph/planner.py``) on
one GPU.

    python3 scripts/torch_planner_sweep.py      # from the repository root

On the bench graph of ``chip_smoke.py`` (169,344 nodes, 128 features, 40
classes, seed 0) the script builds the reordered operator of each mode
once (``build_optimized_graph``), then ``build_hybrid`` again on it at
every threshold of ``planner.THRESHOLD_CANDIDATES``.  The modes:

* ``gcn``: exact GCN on f32 tiles, and ``gcn_bf16`` on bf16 tiles;
* ``gat``: exact GAT on its default switches;
* ``gcn_agg2048`` and ``gcn_agg512``: GCN under ``cluster_agg`` 2048 and
  512;
* ``gat_att2048``: GAT under ``cluster_att`` 2048.

At each point it times ``gc_train_step`` (a 2-layer seed-0 ``NodeModel``
at hidden 512, dropout 0.5 from a seeded generator, ``adam_l2(0.01,
5e-4)``) with CUDA events, 10 steps after 3 warm-ups, and prints T(t) (the
tiles with at least t real edges), E_coo(t) (the real edges left to the
stragglers), both from ``planner.tile_histogram`` of the real edges as
the planner counts them, and the ms.  Then least squares with an
intercept and every rate held at 0 or above (a rate is a cost; without
the bound the collapsed edges' rate, which the data hardly sees, can come
out below 0):

* ``COST_TILE`` and ``COST_EDGE_STATIC``: ms = c + a·T + b·E over ``gcn``;
* ``COST_EDGE_ATT``: ms − a·T = c + b·E over ``gat``;
* ``COST_EDGE_COLLAPSED`` and ``COST_TABLE_COL``: ms − a·T = c + b·E +
  d·(N/128)·C over ``gcn_agg2048`` and ``gcn_agg512`` together (the table
  term differs between the two K only).

The priors are the fastest threshold of ``gcn`` (static), ``gat``
(attention) and ``gcn_agg2048`` (collapsed); the fastest of the other
modes is printed beside them, and so is the planner's pick on the bench
graph under the fitted rates.  The last line is one JSON object with every
point, the fit and the card's name and power limit; it is also written to
``chiprun_out/planner_sweep.json``.

    python3 scripts/torch_planner_sweep.py --fit chiprun_out/planner_sweep.json

fits again from a sweep's saved points, on any machine.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import HIDDEN, NUM_CLASSES, NUM_FEATURES, make_graph  # noqa

# mode → (layer, cluster_att, cluster_agg, bf16 tiles)
MODES = {"gcn": ("GCNConv", 0, 0, False),
         "gcn_bf16": ("GCNConv", 0, 0, True),
         "gat": ("GATConv", 0, 0, False),
         "gcn_agg2048": ("GCNConv", 0, 2048, False),
         "gcn_agg512": ("GCNConv", 0, 512, False),
         "gat_att2048": ("GATConv", 2048, 0, False)}
WARMUP, TIMED = 3, 10


def step_ms(layer: str, g, dev) -> float:
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train import steps

    model = NodeModel(layer, NUM_FEATURES, HIDDEN, 2, NUM_CLASSES)
    model = model.reset_parameters(torch.Generator().manual_seed(0)).to(dev)
    opt = steps.adam_l2(model.parameters(), 0.01, 5e-4)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        steps.gc_train_step(model, opt, g, g.y, g.train_mask, gen,
                            "classification")

    for _ in range(WARMUP):
        step()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED):
        step()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED


def sweep(mode: str, data, dev) -> list:
    from fitgnn_tpu_torch.graph import planner
    from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                                 _operator_weights,
                                                 build_optimized_graph)
    from fitgnn_tpu_torch.ops.hybrid_spmm import build_hybrid

    layer, c_att, c_agg, bf16 = MODES[mode]
    x, s, r, y, train = data
    t0 = time.perf_counter()
    g, _ = build_optimized_graph(x, s, r, y=y, train_mask=train,
                                 layer_name=layer, cluster_att=c_att,
                                 cluster_agg=c_agg, seed=0)
    n_pad = g.num_nodes_padded
    sn = g.senders.numpy().astype(np.int64)
    rn = g.receivers.numpy().astype(np.int64)
    w_op = _operator_weights(sn, rn, g.edge_weight.numpy(), n_pad,
                             _LAYER_SEMANTICS[layer])
    real = w_op > 0
    counts = planner.tile_histogram(sn[real], rn[real], n_pad)
    k = c_att or c_agg
    c_cols = n_pad // k if k else 0
    print(f"{mode}: ingest {time.perf_counter() - t0:.1f} s, N_pad {n_pad}, "
          f"C {c_cols}, {int(real.sum())} real edges in {len(counts)} tiles")
    points = []
    for t in planner.THRESHOLD_CANDIDATES:
        t0 = time.perf_counter()
        h = build_hybrid(sn, rn, w_op, n_pad, min_block_edges=t,
                         tile_dtype=torch.bfloat16 if bf16 else None,
                         use_segmm=True, semantics=_LAYER_SEMANTICS[layer],
                         cluster_att=c_att, cluster_agg=c_agg,
                         real_nodes=int(g.n_node))
        build_s = time.perf_counter() - t0
        gd = g._replace(aux=h).to(dev)
        ms = step_ms(layer, gd, dev)
        dense = counts >= t
        pt = {"mode": mode, "threshold": t, "T": int(dense.sum()),
              "E_coo": int(counts[~dense].sum()), "ms": ms,
              "n_pad": n_pad, "C": c_cols,
              "tiles_built": 0 if h.bsr is None else h.bsr.nnz_blocks,
              "straggler_edges": h.num_coo_edges, "build_s": build_s}
        print(json.dumps(pt))
        points.append(pt)
        del gd, h
        torch.cuda.empty_cache()
    return points


def lstsq(cols: list, y: list) -> np.ndarray:
    """(intercept, rates…) of y = c + Σ rate·col, the rates bounded at 0."""
    from scipy.optimize import lsq_linear
    a = np.column_stack([np.ones(len(y))] + [np.asarray(c, float)
                                             for c in cols])
    lower = np.r_[-np.inf, np.zeros(len(cols))]
    return lsq_linear(a, np.asarray(y, float), bounds=(lower, np.inf),
                      method="bvls").x


def residuals(points: list, rates: dict) -> dict:
    """Each mode's fitted cost against its measured ms: the largest
    residual, and the planner's pick on the bench graph under the rates."""
    out = {}
    by = {}
    for p in points:
        by.setdefault(p["mode"], []).append(p)
    for mode, ps in by.items():
        layer, c_att, c_agg, _ = MODES[mode]
        k = c_att or c_agg
        rate = (rates["COST_EDGE_COLLAPSED"] if k else
                rates["COST_EDGE_ATT"] if layer == "GATConv"
                else rates["COST_EDGE_STATIC"])
        pred = [1e3 * (rates["COST_TILE"] * p["T"] + rate * p["E_coo"]
                       + (rates["COST_TABLE_COL"] * p["n_pad"] / 128 * p["C"]
                          if k else 0.0)) for p in ps]
        ms = [p["ms"] for p in ps]
        c = float(np.mean(np.subtract(ms, pred)))
        prior = (rates["PRIOR_COLLAPSED"] if k else rates["PRIOR_ATT"]
                 if layer == "GATConv" else rates["PRIOR_STATIC"])
        best = min(pred)
        plateau = [p["threshold"] for p, v in zip(ps, pred)
                   if v <= best * 1.02 + 1e-12]
        pick = min(plateau, key=lambda t: abs(t - prior))
        out[mode] = {"max_abs_residual_ms": float(np.max(np.abs(
            np.subtract(ms, np.add(pred, c))))),
            "planner_pick": pick, "fastest": min(
                ps, key=lambda p: p["ms"])["threshold"],
            "ms_at_pick": ms[[p["threshold"] for p in ps].index(pick)],
            "ms_at_48": ms[[p["threshold"] for p in ps].index(48)],
            "ms_fastest": min(ms)}
    return out


def fit(points: list) -> dict:
    """The planner's rates in seconds from the sweep's points (ms)."""
    by = {}
    for p in points:
        by.setdefault(p["mode"], []).append(p)
    gcn = by["gcn"]
    c0, a_ms, b_ms = lstsq([[p["T"] for p in gcn], [p["E_coo"] for p in gcn]],
                           [p["ms"] for p in gcn])
    gat = by["gat"]
    c1, b_att = lstsq([[p["E_coo"] for p in gat]],
                      [p["ms"] - a_ms * p["T"] for p in gat])
    col = by["gcn_agg2048"] + by["gcn_agg512"]
    c2, b_cl, d_ms = lstsq(
        [[p["E_coo"] for p in col], [p["n_pad"] / 128 * p["C"] for p in col]],
        [p["ms"] - a_ms * p["T"] for p in col])
    best = {m: min(ps, key=lambda p: p["ms"])["threshold"]
            for m, ps in by.items()}
    return {"COST_TILE": a_ms * 1e-3, "COST_EDGE_STATIC": b_ms * 1e-3,
            "COST_EDGE_ATT": b_att * 1e-3,
            "COST_EDGE_COLLAPSED": b_cl * 1e-3,
            "COST_TABLE_COL": d_ms * 1e-3,
            "intercepts_ms": {"gcn": c0, "gat": c1, "collapsed": c2},
            "PRIOR_STATIC": best["gcn"], "PRIOR_ATT": best["gat"],
            "PRIOR_COLLAPSED": best["gcn_agg2048"], "fastest": best}


def refit(path: str) -> int:
    with open(path) as f:
        saved = json.load(f)
    rates = fit(saved["points"])
    print(saved["card"])
    for k, v in rates.items():
        print(f"{k} = {v}")
    for mode, v in residuals(saved["points"], rates).items():
        print(f"{mode}: {v}")
    return 0


def main() -> int:
    if sys.argv[1:2] == ["--fit"]:
        return refit(sys.argv[2])
    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 1
    from fitgnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    data = make_graph()
    points = []
    for mode in MODES:
        points.extend(sweep(mode, data, dev))
    rates = fit(points)
    for k, v in rates.items():
        print(f"{k} = {v}")
    check = residuals(points, rates)
    for mode, v in check.items():
        print(f"{mode}: {v}")
    out = {"card": card, "torch": torch.__version__, "points": points,
           "fit": rates, "check": check,
           "seconds": time.perf_counter() - t_start}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "planner_sweep.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
