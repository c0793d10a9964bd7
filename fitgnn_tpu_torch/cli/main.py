"""CLI driver of the port, with the JAX package's subcommands and flags:

    python -m fitgnn_tpu_torch.cli.main train --baseline --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main infer-baseline --dataset cora ...

``train --baseline`` (full-batch training, node tasks, GCN and GAT) and
``infer-baseline`` (the full-graph inference-latency baseline) are ported.
``train`` without ``--baseline``, its unported options, ``infer``,
``memory``, ``stats``, ``save-graphs`` and the graph-level tasks raise
``NotImplementedError`` naming their ROADMAP item.  Every subcommand takes
``--device {cuda,cpu}`` (default ``cuda``); asking for ``cuda`` without a
GPU raises instead of falling back.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional

import numpy as np

FIXED_SPLIT_DATASETS = ("cora", "citeseer", "pubmed", "wikics")

COMMUNITY_NODE_CAP = 165_000

AUTO_COMMUNITY_NODES = 170_000

_NOT_PORTED = {
    "infer": "ROADMAP.md §1 item 4 (coarsening, partition, subgraph infer)",
    "memory": "ROADMAP.md §1 item 4 (memory benches)",
    "stats": "ROADMAP.md §1 item 4 (dataset stats)",
    "save-graphs": "ROADMAP.md §1 item 4 (partition artifact cache)",
}

# train options the port does not run yet: (flag, is set, ROADMAP item)
_TRAIN_NOT_PORTED = (
    ("--num_devices > 1", lambda a: a.num_devices > 1,
     "ROADMAP.md §1 item 4 (distributed paths)"),
    ("--cluster_attention", lambda a: a.cluster_attention,
     "ROADMAP.md §2 (build_hybrid opt-ins)"),
    ("--cluster_attention_exact", lambda a: a.cluster_attention_exact,
     "ROADMAP.md §2 (build_hybrid opt-ins)"),
    ("--cluster_aggregation", lambda a: a.cluster_aggregation,
     "ROADMAP.md §2 (build_hybrid opt-ins)"),
    ("--cluster_aggregation_exact", lambda a: a.cluster_aggregation_exact,
     "ROADMAP.md §2 (build_hybrid opt-ins)"),
    ("--preaggregate", lambda a: a.preaggregate,
     "ROADMAP.md §1 item 2 (layer-0 pre-aggregation)"),
    ("--hybrid_bf16_tiles", lambda a: a.hybrid_bf16_tiles,
     "ROADMAP.md §1 item 2 (bf16 tiles)"),
    ("--auto_config", lambda a: a.auto_config,
     "ROADMAP.md §1 item 2 (ingest planner)"),
    ("--resume", lambda a: a.resume,
     "ROADMAP.md §1 item 2 (resume checkpoints)"),
    ("--checkpoint_every", lambda a: a.checkpoint_every,
     "ROADMAP.md §1 item 2 (resume checkpoints)"),
)


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
                        help="accepted for parity; the baselines ignore it")
        sp.add_argument("--max_buckets", type=int, default=0,
                        help="accepted for parity; the baselines ignore it")
        sp.add_argument("--normalize_features", action="store_true",
                        help="row-wise L1 feature normalization")
        sp.add_argument("--auto_config", action="store_true",
                        help="accepted for parity: infer-baseline ignores "
                        "it, train raises (the ingest planner is not "
                        "ported)")
        sp.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the model runs; cuda raises when no GPU "
                        "is visible")
        return sp

    t = common(sub.add_parser("train"))
    t.add_argument("--exp_setup", type=str, default="Gc_train_2_Gs_infer")
    t.add_argument("--runs", type=int, default=20)
    t.add_argument("--hidden", type=int, default=512)
    t.add_argument("--layer_name", type=str, default="GCNConv")
    t.add_argument("--epochs1", type=int, default=100)
    t.add_argument("--epochs2", type=int, default=300)
    t.add_argument("--num_layers1", type=int, default=2)
    t.add_argument("--num_layers2", type=int, default=2)
    t.add_argument("--batch_size", type=int, default=128)
    t.add_argument("--train_ratio", type=float, default=0.3)
    t.add_argument("--val_ratio", type=float, default=0.2)
    t.add_argument("--lr", type=float, default=0.01)
    t.add_argument("--lr2", type=float, default=None)
    t.add_argument("--weight_decay", type=float, default=5e-4)
    t.add_argument("--gradient_method", type=str, default="GD",
                   choices=["GD", "MB"])
    t.add_argument("--loss_reduction", type=str, default="mean",
                   choices=["mean", "sum"])
    t.add_argument("--multi_prop", action="store_true")
    t.add_argument("--property", type=int, default=0)
    t.add_argument("--train_fitgnn", action="store_true")
    t.add_argument("--baseline", action="store_true",
                   help="full-batch training on the whole graph (the one "
                   "train mode ported so far)")
    t.add_argument("--run_intermediate_inference", action="store_true")
    t.add_argument("--intermediate_inference_freq", type=int, default=10)
    t.add_argument("--early_stopping", type=int, default=0)
    t.add_argument("--hybrid_spmm", choices=("auto", "on", "off"),
                   default="auto",
                   help="attach the Leiden-reordered hybrid aggregation "
                   "operator; auto = on for GCN/GAT at >=65,536 nodes")
    t.add_argument("--hybrid_threshold", type=int, default=48,
                   help="min edges per 128x128 tile to densify it")
    t.add_argument("--hybrid_bf16_tiles", action="store_true")
    t.add_argument("--cluster_attention_exact", type=int, default=0)
    t.add_argument("--cluster_attention", type=int, default=0)
    t.add_argument("--cluster_aggregation", type=int, default=0)
    t.add_argument("--cluster_aggregation_exact", type=int, default=0)
    t.add_argument("--preaggregate", action="store_true")
    t.add_argument("--eval_chunk", type=int, default=0)
    t.add_argument("--chunk_budget", type=int, default=1 << 28)
    t.add_argument("--checkpoint_every", type=int, default=0)
    t.add_argument("--resume", action="store_true")
    t.add_argument("--fused_epochs", action="store_true")
    t.add_argument("--num_devices", type=int, default=1)
    t.add_argument("--num_hosts", type=int, default=1)
    common(sub.add_parser("infer"))
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
        return splits_regression(ds.num_nodes,
                                 getattr(args, "train_ratio", 0.3),
                                 getattr(args, "val_ratio", 0.2),
                                 seed=args.seed)
    if args.experiment == "fixed":
        if ds.train_mask is None:
            raise SystemExit(f"{args.dataset} provides no fixed split")
        return ds.train_mask, ds.val_mask, ds.test_mask
    return splits_classification(ds.y, num_classes, args.experiment,
                                 seed=args.seed)


def checkpoint_path(task: str, output_dir: str) -> str:
    """Where ``train --baseline`` saves and ``infer-baseline`` looks."""
    return os.path.join("save", task, "baseline", output_dir, "model.pt")


def _resolve_checkpoint(args) -> Optional[str]:
    """``--checkpoint``, else the path a baseline ``train`` would save."""
    if args.checkpoint:
        return args.checkpoint
    default = checkpoint_path(args.task, args.output_dir)
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
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils import results as R
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    _check_node_task(args)
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
        model.load_state_dict(restore_params(ckpt))

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


def _check_node_task(args) -> None:
    if args.task in ("graph_cls", "graph_reg"):
        raise NotImplementedError(
            "graph-level tasks are not ported yet (ROADMAP.md §1 item 4)")


def _check_train_args(args) -> None:
    """Raise for every train mode and option the port does not run."""
    if not args.baseline:
        raise NotImplementedError(
            "train without --baseline (the FIT-GNN curriculum: coarsening, "
            "partition, Gc/Gs phases) is not ported yet: ROADMAP.md §1 "
            "item 1")
    for flag, is_set, item in _TRAIN_NOT_PORTED:
        if is_set(args):
            raise NotImplementedError(
                f"train {flag} is not ported yet: {item}")
    _check_node_task(args)


def cmd_train_baseline(args) -> int:
    """Full-graph baseline training, as the JAX package's
    ``_cmd_train_baseline`` (single device): per run a fresh init from
    ``seed + run``; per epoch one full-batch train step then a val eval,
    keeping the parameters of the best val loss; then a warm-up and a
    timed test eval.  The last run's best parameters go to
    ``save/<task>/baseline/<output_dir>/model.pt``, and one row to
    ``results/baseline/<dataset>.csv``.  Dropout draws from a generator
    seeded with ``seed + run`` on the model's device."""
    import torch
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.graph.optimize import (build_optimized_graph,
                                                 should_use_hybrid)
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train import steps
    from fitgnn_tpu_torch.train.checkpoint import save_params
    from fitgnn_tpu_torch.utils import results as R
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds = _load_node(args)
    classify = args.task == "node_cls"
    num_classes = ds.num_classes if classify else None
    train, val, test = _splits(args, ds, num_classes)
    if should_use_hybrid(ds.num_nodes, args.layer_name, args.hybrid_spmm):
        # Leiden reorder + hybrid operator (exact: a node permutation)
        g, _ = build_optimized_graph(
            ds.x, ds.senders, ds.receivers, y=ds.y, train_mask=train,
            val_mask=val, test_mask=test, layer_name=args.layer_name,
            min_block_edges=args.hybrid_threshold, seed=args.seed)
        tiles = 0 if g.aux.bsr is None else g.aux.bsr.nnz_blocks
        print(f"hybrid operator: {tiles} dense tiles, "
              f"{g.aux.num_coo_edges} straggler edges")
    else:
        g = build_graph(ds.x, ds.senders, ds.receivers, y=ds.y,
                        train_mask=train, val_mask=val, test_mask=test)
    g = g.to(device)
    if not classify:
        g = g._replace(y=g.y.float())
    task = "classification" if classify else "regression"

    all_acc, all_loss, all_time = [], [], []
    best_state = None
    for run in range(args.runs):
        seed = args.seed + run
        model = NodeModel(args.layer_name, in_dim=ds.x.shape[1],
                          hidden=args.hidden, num_layers=args.num_layers1,
                          out_dim=num_classes if classify else 1,
                          classify=classify)
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to(device)
        opt = steps.adam_l2(model.parameters(), args.lr, args.weight_decay)
        dropout_gen = torch.Generator(device=device).manual_seed(seed)

        def snapshot():
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}

        best_val, best_state = float("inf"), snapshot()
        for epoch in range(args.epochs1):
            steps.gc_train_step(model, opt, g, g.y, g.train_mask,
                                dropout_gen, task,
                                reduction=args.loss_reduction)
            val_loss, _ = steps.gc_eval_step(model, g, g.y, g.val_mask, task)
            if float(val_loss) < best_val or epoch == 0:
                best_val, best_state = float(val_loss), snapshot()
        model.load_state_dict(best_state)
        steps.gc_eval_step(model, g, g.y, g.test_mask, task)     # warm-up
        t0 = time.perf_counter()
        test_loss, test_acc = steps.gc_eval_step(model, g, g.y, g.test_mask,
                                                 task)
        test_loss, test_acc = float(test_loss), float(test_acc)
        all_time.append(time.perf_counter() - t0)
        all_acc.append(test_acc)
        all_loss.append(test_loss)
        print(f"baseline run {run}: test_loss={test_loss:.4f} "
              f"metric={test_acc:.4f}")

    ckpt = checkpoint_path(args.task, args.output_dir)
    save_params(ckpt, best_state)
    print(f"checkpoint saved: {ckpt}")

    acc, loss = np.asarray(all_acc), np.asarray(all_loss)
    top_acc = np.sort(acc)[::-1][:10]
    # regression: ``acc`` holds the std-normalized L1, the value recorded
    # as the regression loss
    top_loss = np.sort(loss if classify else acc)[:10]
    header = R.TRAIN_NODE_CLS_HEADER if classify else R.TRAIN_NODE_REG_HEADER
    row = R.format_row(header, {
        "dataset": args.dataset, "coarsening_method": "none",
        "coarsening_ratio": "", "experiment": args.experiment,
        "exp_setup": "baseline", "layer_name": args.layer_name,
        "extra_nodes": False, "cluster_node": False,
        "community_used": args.use_community_detection,
        "hidden": args.hidden, "runs": args.runs,
        "num_layers": args.num_layers1, "batch_size": args.batch_size,
        "lr": args.lr,
        "ave_acc": f"{acc.mean()} +/- {acc.std()}",
        "ave_time": float(np.mean(all_time)),
        "top_10_acc": f"{top_acc.mean()} +/- {top_acc.std()}",
        "best_acc": float(top_acc[0]),
        "top_10_loss": f"{top_loss.mean()} +/- {top_loss.std()}",
        "best_loss": float(top_loss[0])})
    R.append_csv_row(f"results/baseline/{args.dataset}.csv", header, row)
    print(f"results/baseline/{args.dataset}.csv <- {row}")
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args, extra = parser.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise NotImplementedError(
            f"subcommand {args.command!r} is not ported yet: "
            f"{_NOT_PORTED[args.command]}")
    if args.command == "train":
        _check_train_args(args)
    if extra:
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    args = arg_correction(args)
    if args.command == "train":
        return cmd_train_baseline(args)
    return cmd_infer_baseline(args)


if __name__ == "__main__":
    raise SystemExit(main())
