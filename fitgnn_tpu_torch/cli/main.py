"""CLI driver of the port, with the JAX package's subcommands and flags:

    python -m fitgnn_tpu_torch.cli.main infer-baseline --dataset cora ...

``infer-baseline`` (the full-graph inference-latency baseline, node tasks)
is ported.  ``train``, ``infer``, ``memory``, ``stats``, ``save-graphs`` and
the graph-level tasks raise ``NotImplementedError`` naming their ROADMAP
item.  Every subcommand takes ``--device {cuda,cpu}`` (default ``cuda``);
asking for ``cuda`` without a GPU raises instead of falling back.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np

FIXED_SPLIT_DATASETS = ("cora", "citeseer", "pubmed", "wikics")

COMMUNITY_NODE_CAP = 165_000

AUTO_COMMUNITY_NODES = 170_000

_NOT_PORTED = {
    "train": "ROADMAP.md §1 item 1 (training slice)",
    "infer": "ROADMAP.md §1 item 4 (coarsening, partition, subgraph infer)",
    "memory": "ROADMAP.md §1 item 4 (memory benches)",
    "stats": "ROADMAP.md §1 item 4 (dataset stats)",
    "save-graphs": "ROADMAP.md §1 item 4 (partition artifact cache)",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fitgnn-tpu-torch")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--dataset", type=str, default="cora")
        sp.add_argument("--data_root", type=str, default="./dataset")
        sp.add_argument("--task", type=str, default="node_cls",
                        choices=["node_cls", "node_reg", "graph_cls",
                                 "graph_reg"])
        sp.add_argument("--coarsening_ratio", type=float, default=0.5)
        sp.add_argument("--coarsening_method", type=str,
                        default="variation_neighborhoods")
        sp.add_argument("--extra_node", action="store_true")
        sp.add_argument("--cluster_node", action="store_true")
        sp.add_argument("--use_community_detection", action="store_true")
        sp.add_argument("--experiment", type=str, default="fixed")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--output_dir", type=str, default="out")
        sp.add_argument("--bucket_sizes", action="store_true",
                        help="accepted for parity; infer-baseline ignores it")
        sp.add_argument("--max_buckets", type=int, default=0,
                        help="accepted for parity; infer-baseline ignores it")
        sp.add_argument("--normalize_features", action="store_true",
                        help="row-wise L1 feature normalization")
        sp.add_argument("--auto_config", action="store_true",
                        help="accepted for parity; infer-baseline ignores it")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs; cuda raises when no GPU "
                        "is visible")
        return sp

    for name in ("train", "infer"):
        common(sub.add_parser(name))
    ib = common(sub.add_parser("infer-baseline"))
    ib.add_argument("--hidden", type=int, default=512)
    ib.add_argument("--layer_name", type=str, default="GCNConv")
    ib.add_argument("--num_layers1", type=int, default=2)
    ib.add_argument("--num_layers2", type=int, default=None,
                    help="inference model depth; defaults to num_layers1")
    ib.add_argument("--num_test_samples", type=int, default=100)
    ib.add_argument("--checkpoint", type=str, default=None,
                    help="a torch.save'd NodeModel state dict; defaults to "
                    "save/<task>/baseline/<output_dir>/model.pt if present")
    for name in ("memory", "stats", "save-graphs"):
        common(sub.add_parser(name))
    return p


def arg_correction(args) -> argparse.Namespace:
    """The reference's ``arg_correction`` semantics."""
    if args.cluster_node and args.extra_node:
        print("warning: cluster_node and extra_node are mutually exclusive; "
              "using extra_node", file=sys.stderr)
        args.cluster_node = False
    if args.experiment == "fixed" and \
            args.dataset.lower() not in FIXED_SPLIT_DATASETS:
        print(f"warning: {args.dataset} has no fixed split; using random",
              file=sys.stderr)
        args.experiment = "random"
    return args


def _load_node(args):
    from fitgnn_tpu_torch.data.datasets import load_node_dataset
    ds = load_node_dataset(args.dataset, args.data_root)
    use_comm = args.use_community_detection
    if not use_comm and ds.num_nodes > AUTO_COMMUNITY_NODES:
        print(f"auto-enabling community detection "
              f"({ds.num_nodes} > {AUTO_COMMUNITY_NODES} nodes)",
              file=sys.stderr)
        use_comm = True
    if use_comm:
        ds = apply_community_proxy(ds, COMMUNITY_NODE_CAP, seed=args.seed)
    if args.normalize_features:
        norms = np.abs(ds.x).sum(axis=1, keepdims=True)
        ds.x = (ds.x / np.maximum(norms, 1e-12)).astype(np.float32)
    return ds


def apply_community_proxy(ds, cap: int, seed: int = 0):
    """Leiden → keep the largest communities up to ``cap`` nodes → induced
    subgraph (the reference's ogbn-products proxy)."""
    import dataclasses as _dc
    from fitgnn_tpu_torch.partition.community import (leiden_communities,
                                                      merge_communities)
    labels = leiden_communities(ds.senders, ds.receivers, ds.num_nodes,
                                seed=seed)
    keep = merge_communities(labels, cap)
    lookup = np.full(ds.num_nodes, -1, dtype=np.int64)
    lookup[keep] = np.arange(len(keep))
    sel = (lookup[ds.senders] >= 0) & (lookup[ds.receivers] >= 0)

    def sub(a):
        return None if a is None else np.asarray(a)[keep]

    return _dc.replace(
        ds, x=ds.x[keep], y=np.asarray(ds.y)[keep],
        senders=lookup[ds.senders[sel]], receivers=lookup[ds.receivers[sel]],
        train_mask=sub(ds.train_mask), val_mask=sub(ds.val_mask),
        test_mask=sub(ds.test_mask))


def _splits(args, ds, num_classes):
    from fitgnn_tpu_torch.data.splits import (splits_classification,
                                              splits_regression)
    if args.task == "node_reg":
        # infer-baseline has no ratio flags: the train defaults apply
        return splits_regression(ds.num_nodes, 0.3, 0.2, seed=args.seed)
    if args.experiment == "fixed":
        if ds.train_mask is None:
            raise SystemExit(f"{args.dataset} provides no fixed split")
        return ds.train_mask, ds.val_mask, ds.test_mask
    return splits_classification(ds.y, num_classes, args.experiment,
                                 seed=args.seed)


def _resolve_checkpoint(args) -> Optional[str]:
    """``--checkpoint``, else the path a baseline ``train`` would save."""
    if args.checkpoint:
        return args.checkpoint
    default = os.path.join("save", args.task, "baseline", args.output_dir,
                           "model.pt")
    if os.path.exists(default):
        print(f"using checkpoint from train: {default}", file=sys.stderr)
        return default
    print("WARNING: no checkpoint found at "
          f"{default} and no --checkpoint given — timing RANDOM params "
          "(losses/accuracies below are meaningless)", file=sys.stderr)
    return None


def cmd_infer_baseline(args) -> int:
    import torch
    from fitgnn_tpu_torch.bench.inference import baseline_inference_benchmark
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.graph.optimize import (build_optimized_graph,
                                                 should_use_hybrid)
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.utils import results as R
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.task in ("graph_cls", "graph_reg"):
        raise NotImplementedError(
            "graph-level tasks are not ported yet (ROADMAP.md §1 item 4)")

    ds = _load_node(args)
    classify = args.task == "node_cls"
    num_classes = ds.num_classes if classify else None
    _, _, test = _splits(args, ds, num_classes)

    depth = args.num_layers2 if args.num_layers2 is not None \
        else args.num_layers1
    model = NodeModel(args.layer_name, in_dim=ds.x.shape[1],
                      hidden=args.hidden, num_layers=depth,
                      out_dim=num_classes if classify else 1,
                      classify=classify)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    ckpt = _resolve_checkpoint(args)
    if ckpt:
        model.load_state_dict(torch.load(ckpt, map_location="cpu",
                                         weights_only=True))

    test_m, y_m = test, ds.y
    if should_use_hybrid(ds.num_nodes, args.layer_name):
        # the timed forward gets the production fast path (permutation-exact)
        g, order = build_optimized_graph(
            ds.x, ds.senders, ds.receivers,
            layer_name=args.layer_name, seed=args.seed)
        test_m = np.asarray(test)[order]
        y_m = np.asarray(ds.y)[order]
    else:
        g = build_graph(ds.x, ds.senders, ds.receivers)
    rep = baseline_inference_benchmark(
        model.to(device), g.to(device), test_m, y_m,
        num_samples=args.num_test_samples, classify=classify,
        seed=args.seed)

    row = R.format_row(R.INFERENCE_HEADER, {
        "dataset": args.dataset, "coarsening_method": args.coarsening_method,
        "coarsening_ratio": args.coarsening_ratio, "exp_setup": "baseline",
        "layer_name": args.layer_name, "extra_nodes": args.extra_node,
        "cluster_node": args.cluster_node,
        "community_used": args.use_community_detection,
        "hidden": args.hidden, "num_layers": args.num_layers1,
        "num_test_samples": rep.num_test_samples,
        "avg_inf_time": rep.avg_inf_time, "avg_loss": rep.avg_loss,
        "acc": rep.acc, "avg_inf_time_device": rep.avg_inf_time_device})
    R.append_csv_row(f"inference_results/{args.task}.csv",
                     R.INFERENCE_HEADER, row)
    print(f"inference_results/{args.task}.csv <- {row}")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise NotImplementedError(
            f"subcommand {args.command!r} is not ported yet: "
            f"{_NOT_PORTED[args.command]}")
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    return cmd_infer_baseline(arg_correction(args))


if __name__ == "__main__":
    raise SystemExit(main())
