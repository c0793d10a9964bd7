"""Append-only results CSVs, column-compatible with the JAX package."""

from __future__ import annotations

import os
from typing import Mapping

TRAIN_NODE_CLS_HEADER = (
    "dataset,coarsening_method,coarsening_ratio,experiment,exp_setup,"
    "layer_name,extra_nodes,cluster_node,community_used,hidden,runs,"
    "num_layers,batch_size,lr,ave_acc,ave_time,top_10_acc,best_acc,"
    "top_10_loss,best_loss")

TRAIN_NODE_REG_HEADER = (
    "dataset,coarsening_method,coarsening_ratio,layer_name,extra_nodes,"
    "cluster_node,community_used,hidden,runs,num_layers,batch_size,lr,"
    "ave_time,top_10_loss,best_loss")

# avg_inf_time is wall-clock per sampled forward; avg_inf_time_device is
# the device time of one forward (bench.inference)
INFERENCE_HEADER = (
    "dataset,coarsening_method,coarsening_ratio,exp_setup,layer_name,"
    "extra_nodes,cluster_node,community_used,hidden,num_layers,"
    "num_test_samples,avg_inf_time,avg_loss,acc,avg_inf_time_device")


def append_csv_row(path: str, header: str, row: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not os.path.exists(path):
        with open(path, "w") as f:
            f.write(header + "\n")
    with open(path, "a") as f:
        f.write(row + "\n")


def format_row(header: str, values: Mapping[str, object]) -> str:
    """Build a row from a dict keyed by (case-insensitive) column names;
    missing columns become empty fields."""
    lower = {k.lower(): v for k, v in values.items()}
    out = []
    for col in header.split(","):
        v = lower.get(col.lower().split("(")[0], "")
        out.append(str(v))
    return ",".join(out)
