"""CLI driver of the port, with the JAX package's subcommands and flags:

    python -m fitgnn_tpu_torch.cli.main train --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main infer --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main train --baseline --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main infer-baseline --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main memory      --dataset cora ...
    python -m fitgnn_tpu_torch.cli.main stats       --dataset cora
    python -m fitgnn_tpu_torch.cli.main save-graphs --dataset cora ...

Ported, for node tasks with GCN, GAT, SAGE and GIN: ``train`` (the FIT-GNN
curriculum: coarsening, partition, the three Gc/Gs setups in GD and MB),
``infer`` (the subgraph inference-latency benchmark, from the checkpoint
``train`` saved), ``train --baseline`` (full-batch training, with layer-0
pre-aggregation under ``--preaggregate`` for GCN, SAGE and GIN) and
``infer-baseline`` (the full-graph inference-latency baseline).
``train --baseline --num_devices P --num_hosts H`` trains the full graph
sharded over P ranks through the hierarchical exchange
(``parallel/hierarchical.py``), and ``train --num_devices P --num_hosts
H`` runs the curriculum distributed: the Gc phase on that exchange, the
Gs phase sharded over the subgraph axis (``parallel/dist_subgraphs.py``).
The CLI starts the P ranks itself (``torch.multiprocessing``), or runs as
one of them under a ``torchrun`` world of size P; ``--device cuda`` takes
card ``r`` for rank ``r`` over NCCL, ``--device cpu`` runs the ranks on
the CPU over gloo.
``train --hybrid_bf16_tiles`` stores the hybrid operator's tiles in bf16
on ``--baseline`` and in the curriculum's Gc phase; ``infer`` and
``infer-baseline`` take no such flag, as in the JAX package.  ``train
--cluster_aggregation K`` (GCN, SAGE, GIN) and ``--cluster_attention K``
(GAT), with their ``_exact`` splits, collapse the hybrid operator's
stragglers onto cluster summaries on ``--baseline`` and in the Gc phase
(approximate by design, as in the JAX package).  ``--auto_config`` on
every subcommand sets the bucket cap and chunk budget from the graph's
size, and on ``train`` takes the tile threshold from the ingest planner
(``graph/planner.py``).
``train`` and ``infer`` take size-bucketed subgraph batches
(``--bucket_sizes``, ``--max_buckets``); ``train`` the chunked Gs eval
(``--eval_chunk``), the Gc phase without a host read per epoch
(``--fused_epochs``) and mid-training resume (``--resume``,
``--checkpoint_every``).  The graph-level tasks (``--task graph_cls`` and
``graph_reg``) run the per-graph pipeline on a ``<name>_graphs.npz``
cache: ``train`` (and ``train --baseline``, which the JAX package sends
to the same path) coarsens each graph, collates the splits in chunks of
``--batch_size`` and runs one of the four graph setups, saving the best
parameters to ``save/<task>/<output_dir>/model.pt``; ``infer`` (and
``infer-baseline``) times one forward per graph in the Gs and in the Gc
view from that checkpoint.  ``memory`` appends the full graph's and the
largest subgraph's byte footprint (node tasks; the Gs chunk, Gc chunk and
largest molecule on graph tasks) to ``memory_usage.csv``, ``stats`` the
dataset's sizes and homophily to ``dataset_info.csv``, and
``save-graphs`` computes the partition into the port's artifact cache,
where ``train``, ``infer`` and ``memory`` on the same flags find it.
Every subcommand takes
``--device {cuda,cpu}`` (default ``cuda``); asking for ``cuda`` without a
GPU raises instead of falling back.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time
from typing import Optional

import numpy as np

FIXED_SPLIT_DATASETS = ("cora", "citeseer", "pubmed", "wikics")

COMMUNITY_NODE_CAP = 165_000

AUTO_COMMUNITY_NODES = 170_000

GRAPH_TASKS = ("graph_cls", "graph_reg")

# the resume flags under --baseline: the JAX package's baseline reads
# neither, so the port refuses them rather than ignore them
_BASELINE_NO_RESUME = (("--resume", lambda a: a.resume),
                       ("--checkpoint_every", lambda a: a.checkpoint_every))


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
                        help="size-bucket the subgraph batches (pad within "
                        "power-of-two node-count buckets, at least 32); "
                        "the baselines ignore it")
        sp.add_argument("--max_buckets", type=int, default=0,
                        help="cap the bucket count by merging adjacent "
                        "buckets with the least added padding; 0 = one "
                        "bucket per power of two")
        sp.add_argument("--normalize_features", action="store_true",
                        help="row-wise L1 feature normalization")
        sp.add_argument("--auto_config", action="store_true",
                        help="derive the bucket cap and chunk budget from "
                        "the graph's size and, on train, the hybrid tile "
                        "threshold from the ingest planner "
                        "(graph/planner.py); on every subcommand so the "
                        "partition cache key stays consistent")
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
                   help="full-batch training on the whole graph instead of "
                   "the FIT-GNN curriculum")
    t.add_argument("--run_intermediate_inference", action="store_true")
    t.add_argument("--intermediate_inference_freq", type=int, default=10)
    t.add_argument("--early_stopping", type=int, default=0)
    t.add_argument("--hybrid_spmm", choices=("auto", "on", "off"),
                   default="auto",
                   help="attach the Leiden-reordered hybrid aggregation "
                   "operator to full-graph training (--baseline, and the Gc "
                   "phase of the curriculum); auto = on at >=65,536 "
                   "nodes")
    t.add_argument("--hybrid_threshold", type=int, default=48,
                   help="min edges per 128x128 tile to densify it")
    t.add_argument("--hybrid_bf16_tiles", action="store_true",
                   help="store the dense adjacency tiles in bfloat16 "
                   "(the walks' bf16 forms; x rounded to bf16 as the JAX "
                   "package rounds it, f32 accumulation)")
    t.add_argument("--cluster_attention_exact", type=int, default=0,
                   help="with --cluster_attention: the top-k straggler "
                   "senders (by straggler out-degree) keep the exact "
                   "per-edge attention path; only the tail collapses onto "
                   "cluster summaries")
    t.add_argument("--cluster_attention", type=int, default=0,
                   help="GATConv full-graph training: collapse straggler "
                   "edges onto their sender's cluster-summary row "
                   "(APPROXIMATE: the reference's cluster_node idea applied "
                   "to attention; one dense (N, C) block instead of the "
                   "per-edge softmax). Value = nodes per cluster, multiple "
                   "of 128; 0 = exact per-edge (default)")
    t.add_argument("--cluster_aggregation", type=int, default=0,
                   help="GCN/SAGE/GIN full-graph training: the static-weight "
                   "analog of --cluster_attention: straggler edges "
                   "aggregate their sender's cluster-mean row through one "
                   "(N, C) product (APPROXIMATE). Value = nodes per "
                   "cluster, multiple of 128; 0 = exact per-edge (default)")
    t.add_argument("--cluster_aggregation_exact", type=int, default=0,
                   help="with --cluster_aggregation: the top-k straggler "
                   "senders (by straggler weight mass) keep the exact "
                   "per-edge path; only the tail collapses")
    t.add_argument("--preaggregate", action="store_true",
                   help="--baseline with GCN, SAGE or GIN: aggregate layer "
                   "0's input once at ingest (exact; the checkpoint loads "
                   "into the plain model); GAT and the curriculum ignore "
                   "it")
    t.add_argument("--eval_chunk", type=int, default=0,
                   help="evaluate the subgraphs in slices of this many per "
                   "bucket (capped by --chunk_budget); 0 = all at once")
    t.add_argument("--chunk_budget", type=int, default=1 << 28)
    t.add_argument("--checkpoint_every", type=int, default=0,
                   help="save the resume checkpoint every this many epochs "
                   "(and at phase and run boundaries); without --resume a "
                   "stale one is deleted first")
    t.add_argument("--resume", action="store_true",
                   help="take up the resume checkpoint of this output_dir "
                   "(save/<task>/<output_dir>/resume/) if there is one")
    t.add_argument("--fused_epochs", action="store_true",
                   help="run the Gc phase without a host read per epoch "
                   "(ignored under --early_stopping)")
    t.add_argument("--num_devices", type=int, default=1)
    t.add_argument("--num_hosts", type=int, default=1)
    i = common(sub.add_parser("infer"))
    i.add_argument("--hidden", type=int, default=512)
    i.add_argument("--layer_name", type=str, default="GCNConv")
    i.add_argument("--num_layers1", type=int, default=2)
    i.add_argument("--num_layers2", type=int, default=None,
                   help="inference model depth; defaults to num_layers1")
    i.add_argument("--num_test_samples", type=int, default=100)
    i.add_argument("--checkpoint", type=str, default=None,
                   help="a torch.save'd NodeModel (GraphModel on a graph task) "
                   "state dict; defaults to "
                   "save/<task>/<output_dir>/model.pt if present")
    ib = common(sub.add_parser("infer-baseline"))
    ib.add_argument("--hidden", type=int, default=512)
    ib.add_argument("--layer_name", type=str, default="GCNConv")
    ib.add_argument("--num_layers1", type=int, default=2)
    ib.add_argument("--num_layers2", type=int, default=None,
                    help="inference model depth; defaults to num_layers1")
    ib.add_argument("--num_test_samples", type=int, default=100)
    ib.add_argument("--checkpoint", type=str, default=None,
                    help="a torch.save'd NodeModel (GraphModel on a graph task) "
                   "state dict; defaults to "
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
    if getattr(args, "train_fitgnn", False) and getattr(args, "baseline",
                                                        False):
        print("warning: train_fitgnn overrides baseline", file=sys.stderr)
        args.baseline = False
    return args


def _node_mode(args) -> str:
    if args.extra_node:
        return "extra_node"
    if args.cluster_node:
        return "cluster_node"
    return "plain"


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


def _partition(args, ds, train, val, test, num_classes):
    """Load or compute the partition through the port's content-keyed
    cache, ``<data_root>/<dataset>/saved/fitgnn_tpu_torch/<key>.pkl``: the
    JAX package's key entries plus one of the port's own, so the port
    never reads the JAX package's artifacts."""
    from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition
    from fitgnn_tpu_torch.utils.cache import (ARTIFACT_KIND, ArtifactCache,
                                              content_key)

    task = "classification" if args.task.endswith("cls") else "regression"

    def compute():
        t0 = time.perf_counter()
        part = coarsen_and_partition(
            ds.x, ds.senders, ds.receivers, ds.y,
            reduction=1.0 - args.coarsening_ratio,  # reference ratio semantics
            method=args.coarsening_method, mode=_node_mode(args), task=task,
            num_classes=num_classes, train_mask=train, val_mask=val,
            test_mask=test, seed=args.seed, bucket=args.bucket_sizes,
            max_buckets=args.max_buckets)
        print(f"partition: {time.perf_counter() - t0:.2f} s host, "
              f"{part.num_metanodes} metanodes", file=sys.stderr)
        return part

    cache = ArtifactCache(os.path.join(args.data_root, args.dataset,
                                       "saved", ARTIFACT_KIND))

    def _mask_arr(m):
        return (np.asarray(m, dtype=np.uint8) if m is not None
                else np.asarray([-1], dtype=np.int64))

    key = content_key(
        {"x": ds.x[:1000], "senders": ds.senders, "receivers": ds.receivers,
         "y": np.asarray(ds.y)[:1000], "train_mask": _mask_arr(train),
         "val_mask": _mask_arr(val), "test_mask": _mask_arr(test)},
        {"ratio": args.coarsening_ratio, "method": args.coarsening_method,
         "mode": _node_mode(args), "task": args.task, "seed": args.seed,
         "bucket": args.bucket_sizes, "max_buckets": args.max_buckets,
         "artifact": ARTIFACT_KIND})
    part, hit = cache.load_or_compute(key, compute)
    if hit:
        print(f"partition artifacts loaded from cache ({key})",
              file=sys.stderr)
    return part


def checkpoint_path(task: str, output_dir: str,
                    baseline: bool = True) -> str:
    """Where ``train`` saves and ``infer`` looks
    (``save/<task>/<output_dir>/model.pt``), or with ``baseline`` where
    ``train --baseline`` saves and ``infer-baseline`` looks
    (``save/<task>/baseline/<output_dir>/model.pt``)."""
    parts = ["save", task] + (["baseline"] if baseline else []) + [output_dir]
    return os.path.join(*parts, "model.pt")


def _resolve_checkpoint(args, baseline: bool = True) -> Optional[str]:
    """``--checkpoint``, else the path the matching ``train`` would save."""
    if args.checkpoint:
        return args.checkpoint
    default = checkpoint_path(args.task, args.output_dir, baseline)
    if os.path.exists(default):
        print(f"using checkpoint from train: {default}", file=sys.stderr)
        return default
    print("WARNING: no checkpoint found at "
          f"{default} and no --checkpoint given — timing RANDOM params "
          "(losses/accuracies below are meaningless)", file=sys.stderr)
    return None


def _apply_auto_config(args, num_nodes: int) -> None:
    """``--auto_config``, as the JAX package's ``_apply_auto_config``: on
    train the tile threshold becomes ``"auto"`` (the planner picks it from
    the reordered tile histogram inside ``build_optimized_graph`` or
    ``optimize_coarse``); on every subcommand the bucket cap and the chunk
    budget follow the graph's size, so that the partition and its cache key
    are the JAX package's.  The values (2 buckets, 1<<26 elements) are the
    JAX package's and were not measured on this card."""
    if not getattr(args, "auto_config", False):
        return
    if hasattr(args, "hybrid_threshold"):        # train only
        args.hybrid_threshold = "auto"
    # the subgraph count is about nodes · (1 - ratio)
    est_subgraphs = int(num_nodes
                        * (1.0 - getattr(args, "coarsening_ratio", 0.5)))
    big = num_nodes >= 1_000_000 or est_subgraphs >= 50_000
    if (big and getattr(args, "bucket_sizes", False)
            and not getattr(args, "max_buckets", 0)):
        args.max_buckets = 2
    if big and getattr(args, "chunk_budget", 1 << 28) == (1 << 28):
        args.chunk_budget = 1 << 26
    print(f"auto-config: tile threshold deferred to planner, "
          f"max_buckets={getattr(args, 'max_buckets', 0) or 'default'}, "
          f"chunk_budget={getattr(args, 'chunk_budget', 1 << 28)}")


def _inference_row(args, rep, tag: str) -> int:
    from fitgnn_tpu_torch.utils import results as R
    row = R.format_row(R.INFERENCE_HEADER, {
        "dataset": args.dataset, "coarsening_method": args.coarsening_method,
        "coarsening_ratio": args.coarsening_ratio, "exp_setup": tag,
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


def cmd_infer(args) -> int:
    """The subgraph inference-latency benchmark, as the JAX package's
    ``cmd_infer``: partition (through the cache), restore the checkpoint
    ``train`` saved, then one forward of each sampled test node's own
    subgraph; one row to ``inference_results/<task>.csv``."""
    import torch
    from fitgnn_tpu_torch.bench.inference import node_inference_benchmark
    from fitgnn_tpu_torch.graph.container import SubgraphBatch
    from fitgnn_tpu_torch.models.models import NodeModel
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    classify = args.task == "node_cls"
    num_classes = ds.num_classes if classify else None
    train, val, test = _splits(args, ds, num_classes)
    part = _partition(args, ds, train, val, test, num_classes)

    depth = args.num_layers2 if args.num_layers2 is not None \
        else args.num_layers1
    model = NodeModel(args.layer_name, in_dim=ds.x.shape[1],
                      hidden=args.hidden, num_layers=depth,
                      out_dim=num_classes if classify else 1,
                      classify=classify)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    ckpt = _resolve_checkpoint(args, baseline=False)
    if ckpt:
        model.load_state_dict(restore_params(ckpt))
    batches = ((part.subgraphs,) if isinstance(part.subgraphs, SubgraphBatch)
               else part.subgraphs)
    rep = node_inference_benchmark(
        model.to(device), tuple(b.to(device) for b in batches), part.parent,
        test, ds.y, num_samples=args.num_test_samples, classify=classify,
        seed=args.seed, subgraph_index=part.subgraph_index)
    return _inference_row(args, rep, "fitgnn")


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
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
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
    ckpt = _resolve_checkpoint(args, baseline=True)
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

    return _inference_row(args, rep, "baseline")


def _check_cluster_args(args) -> None:
    """The JAX package's ``cmd_train`` refusals of the cluster flags, with
    its messages and in its order, before any partition (the one that
    needs the partition, a setup with no Gc phase, is in ``cmd_train``)."""
    cl_att, cl_agg = args.cluster_attention, args.cluster_aggregation
    if args.cluster_attention_exact and not cl_att:
        raise SystemExit("--cluster_attention_exact requires "
                         "--cluster_attention")
    if args.cluster_aggregation_exact and not cl_agg:
        raise SystemExit("--cluster_aggregation_exact requires "
                         "--cluster_aggregation")
    if (cl_att or cl_agg) and args.task in GRAPH_TASKS:
        raise SystemExit("--cluster_attention/--cluster_aggregation apply "
                         "to node-level full-graph training, not "
                         "graph-level tasks")
    if cl_att and args.layer_name != "GATConv":
        raise SystemExit("--cluster_attention is an attention "
                         "factorization (GATConv only)")
    if cl_agg and args.layer_name == "GATConv":
        raise SystemExit("--cluster_aggregation is for static-weight "
                         "layers; use --cluster_attention for GATConv")
    if (cl_att or cl_agg) and args.exp_setup == "Gs_train_2_Gs_infer":
        raise SystemExit(_NO_GC_PHASE)


_NO_GC_PHASE = ("--cluster_attention/--cluster_aggregation apply to the Gc "
                "full-graph phase; this experiment setup has none (use "
                "--baseline for full-graph training)")


def _cluster_kwargs(args) -> dict:
    return dict(cluster_att=args.cluster_attention,
                cluster_att_exact=args.cluster_attention_exact,
                cluster_agg=args.cluster_aggregation,
                cluster_agg_exact=args.cluster_aggregation_exact)


def _operator_line(hyb, cluster_att: int) -> str:
    """The hybrid operator's line, as the JAX package prints it: tiles,
    stragglers and, under a collapse, the table's entries."""
    nca = (0 if hyb.cluster_count is None
           else int((hyb.cluster_count > 0).sum()))
    kind = "attention" if cluster_att else "aggregation"
    return (f"{0 if hyb.bsr is None else hyb.bsr.nnz_blocks} dense tiles, "
            f"{hyb.num_coo_edges} straggler edges"
            + (f", {nca} cluster-{kind} entries (K={hyb.cluster_size}, "
               "approximate)" if nca else ""))


def _check_train_args(args) -> None:
    """Raise for the resume flags under ``--baseline`` (the baseline
    ignores ``--bucket_sizes``, ``--eval_chunk`` and ``--fused_epochs``,
    and the curriculum ``--preaggregate``, as the JAX package's do)."""
    if args.baseline:
        for flag, is_set in _BASELINE_NO_RESUME:
            if is_set(args):
                raise NotImplementedError(
                    f"train --baseline {flag}: the JAX package's baseline "
                    "has no resume (it reads neither --resume nor "
                    "--checkpoint_every), so neither has the port's "
                    "(ROADMAP.md §1, resume)")


def _tile_dtype(args):
    """The hybrid operator's tile type: bf16 under ``--hybrid_bf16_tiles``
    (the walks' bf16 forms), else f32 (None)."""
    import torch
    return torch.bfloat16 if args.hybrid_bf16_tiles else None


def cmd_train_baseline(args) -> int:
    """Full-graph baseline training, as the JAX package's
    ``_cmd_train_baseline`` (single device): with ``--preaggregate`` (GCN,
    SAGE, GIN) layer 0's aggregation runs once here, on the device; per run
    a fresh init from ``seed + run``; per epoch one full-batch train step
    then a val eval,
    keeping the parameters of the best val loss; then a warm-up and a
    timed test eval.  The last run's best parameters go to
    ``save/<task>/baseline/<output_dir>/model.pt``, and one row to
    ``results/baseline/<dataset>.csv``.  Dropout draws from a generator
    seeded with ``seed + run`` on the model's device."""
    import torch
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.graph.optimize import (build_optimized_graph,
                                                 should_use_hybrid)
    from fitgnn_tpu_torch.models.models import NodeModel, preaggregate_input
    from fitgnn_tpu_torch.train import steps
    from fitgnn_tpu_torch.train.checkpoint import save_params
    from fitgnn_tpu_torch.utils import results as R
    from fitgnn_tpu_torch.utils.device import resolve_device

    if args.num_devices > 1:
        return _cmd_train_baseline_dist(args)
    device = resolve_device(args.device)
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    classify = args.task == "node_cls"
    num_classes = ds.num_classes if classify else None
    train, val, test = _splits(args, ds, num_classes)
    if (args.cluster_attention or args.cluster_aggregation
            or should_use_hybrid(ds.num_nodes, args.layer_name,
                                 args.hybrid_spmm)):
        # Leiden reorder + hybrid operator (exact: a node permutation); a
        # cluster collapse needs the operator and makes the stragglers
        # approximate
        g, _ = build_optimized_graph(
            ds.x, ds.senders, ds.receivers, y=ds.y, train_mask=train,
            val_mask=val, test_mask=test, layer_name=args.layer_name,
            min_block_edges=args.hybrid_threshold,
            tile_dtype=_tile_dtype(args), seed=args.seed,
            **_cluster_kwargs(args))
        print(f"hybrid operator: "
              f"{_operator_line(g.aux, args.cluster_attention)}")
    else:
        g = build_graph(ds.x, ds.senders, ds.receivers, y=ds.y,
                        train_mask=train, val_mask=val, test_mask=test)
    g = g.to(device)
    if not classify:
        g = g._replace(y=g.y.float())
    task = "classification" if classify else "regression"
    preagg = args.preaggregate and args.layer_name in (
        "GCNConv", "SAGEConv", "GINConv")
    if preagg:
        # exact: the input features are constant, so layer 0's aggregation
        # moves to ingest; the parameters are the plain model's
        with torch.no_grad():
            g = g._replace(x=preaggregate_input(g, args.layer_name))

    all_acc, all_loss, all_time = [], [], []
    best_state = None
    for run in range(args.runs):
        seed = args.seed + run
        model = NodeModel(args.layer_name, in_dim=ds.x.shape[1],
                          hidden=args.hidden, num_layers=args.num_layers1,
                          out_dim=num_classes if classify else 1,
                          classify=classify,
                          first_layer_preaggregated=preagg)
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

    ckpt = checkpoint_path(args.task, args.output_dir, baseline=True)
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


def _cmd_train_baseline_dist(args) -> int:
    """Full-graph baseline training sharded over a (num_hosts × chips) mesh
    of ``--num_devices`` ranks, as the JAX package's
    ``_cmd_train_baseline_dist``: ``_baseline_dist_run`` on each rank."""
    return _start_ranks(args, _baseline_dist_run)


def _start_ranks(args, body) -> int:
    """The refusals of ``--num_devices P``, then the P ranks, each running
    ``body(args, rank, device)`` (``_dist_rank``): started with
    ``torch.multiprocessing`` or, under a ``torchrun`` world of size P,
    this process being one of them.  ``--device cuda`` needs P cards and
    never runs on the CPU."""
    from fitgnn_tpu_torch.parallel import LAYER_SEMANTICS, chips_per_host

    P = args.num_devices
    try:
        chips_per_host(P, args.num_hosts)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.device == "cuda":
        import torch
        found = torch.cuda.device_count()
        if found < P:
            raise SystemExit(f"num_devices={P} but only {found} CUDA "
                             f"devices (--device cpu runs the {P} ranks on "
                             "the CPU over gloo)")
    if args.layer_name not in LAYER_SEMANTICS:
        raise SystemExit(f"unknown --layer_name {args.layer_name}")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        # one rank of a torchrun world (env:// rendezvous)
        if int(os.environ["WORLD_SIZE"]) != P:
            raise SystemExit(f"--num_devices {P} but the torchrun world "
                             f"has {os.environ['WORLD_SIZE']} ranks")
        _dist_rank(int(os.environ["RANK"]), args, None, body)
        return 0
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_dist_rank, args=(args, f"file://{tmp}/store", body),
                 nprocs=P, join=True)
    return 0


def _dist_rank(rank: int, args, init_method, body) -> None:
    """One rank of ``--num_devices P``: card ``LOCAL_RANK`` (else
    ``rank``) over NCCL under ``--device cuda``, the CPU over gloo (the
    host's cores shared among the ranks) under ``--device cpu``; the
    process group, then ``body`` with every rank but 0 printing
    nothing."""
    import contextlib
    import torch
    import torch.distributed as dist
    from fitgnn_tpu_torch.parallel import initialize_distributed
    from fitgnn_tpu_torch.utils.device import resolve_device

    P = args.num_devices
    if args.device == "cuda":
        device = resolve_device(
            f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
    else:
        device = resolve_device("cpu")
        torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // P))
    initialize_distributed(device, init_method,
                           rank if init_method else None,
                           P if init_method else None)
    quiet = (contextlib.redirect_stdout(open(os.devnull, "w")) if rank
             else contextlib.nullcontext())
    try:
        with quiet:
            body(args, rank, device)
    finally:
        dist.destroy_process_group()


def _baseline_dist_run(args, rank, device) -> None:
    """One rank of ``train --baseline --num_devices P``: every rank makes
    the host-side plan as the JAX package makes it (Leiden on the full
    graph, community placement, ``shard_graph`` under the layer's
    semantics, clusters made shard-local, ``build_hier_plan`` at its
    default threshold of 150) and builds its own interior operator; per run
    the parameters from ``seed + run`` (the same on every rank), the epochs
    with best-val tracking, a warm-up and a timed test eval.  Rank 0 prints,
    saves the best parameters of all runs to
    ``save/<task>/baseline/<output_dir>/model.pt`` (a ``NodeModel`` state
    dict) and appends the ``baseline_dist_{H}x{D}`` row."""
    import torch
    from fitgnn_tpu_torch.parallel import (LAYER_SEMANTICS, HierNodeModel,
                                           build_hier_plan, hier_eval_step,
                                           hier_train_step,
                                           init_hier_params,
                                           make_hier_mesh,
                                           placement_by_community,
                                           shard_graph)
    from fitgnn_tpu_torch.parallel.collectives import all_reduce_sum
    from fitgnn_tpu_torch.partition.community import leiden_communities
    from fitgnn_tpu_torch.train.checkpoint import save_params
    from fitgnn_tpu_torch.train.steps import adam_l2
    from fitgnn_tpu_torch.utils import results as R

    P, H = args.num_devices, args.num_hosts
    D = P // H
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    classify = args.task == "node_cls"
    num_classes = ds.num_classes if classify else None
    train, val, test = _splits(args, ds, num_classes)
    labels = leiden_communities(ds.senders, ds.receivers, ds.num_nodes,
                                seed=args.seed)
    order, _ = placement_by_community(labels, P)
    semantics = LAYER_SEMANTICS[args.layer_name]
    sg = shard_graph(ds.x, ds.senders, ds.receivers, np.asarray(ds.y), P,
                     train_mask=train, val_mask=val, test_mask=test,
                     order=order, semantics=semantics)
    # clusters = communities made shard-local: shard_graph slices uniform
    # n_loc blocks that need not align with the placement, so a community
    # straddling a slice boundary is split at it; padding nodes get an
    # inert cluster of each shard
    n_loc = sg.nodes_per_shard
    n_pad_total = sg.num_nodes_global
    lab_ordered = np.concatenate(
        [labels[order], np.full(n_pad_total - len(order),
                                labels.max() + 1, dtype=np.int64)])
    shard_idx = np.arange(n_pad_total) // n_loc
    pair = shard_idx * (int(lab_ordered.max()) + 2) + lab_ordered
    _, cluster_of = np.unique(pair, return_inverse=True)
    plan = build_hier_plan(sg.senders, sg.receivers, sg.edge_weight, H, D,
                           n_loc, cluster_of, interior_hybrid=True,
                           interior_semantics=semantics)
    mesh = make_hier_mesh(H, D)
    rp = plan.local(mesh, device)
    # every rank's interior split, printed by rank 0 (tiles, stragglers)
    split = torch.zeros((P, 2), dtype=torch.int64, device=device)
    hyb = rp.int_hybrid
    split[rank, 0] = 0 if hyb.bsr is None else hyb.bsr.nnz_blocks
    split[rank, 1] = hyb.num_coo_edges
    split = all_reduce_sum(split).tolist()
    print(f"hier interior operators ({H}x{D} mesh, threshold "
          f"{plan.interior['min_block_edges']}): "
          + ", ".join(f"rank {p} {t} dense tiles / {e} straggler edges"
                      for p, (t, e) in enumerate(split)))
    shard = sg.local(rank, device)
    task = "classification" if classify else "regression"
    x, y = shard.x, shard.y

    all_acc, all_loss, all_time = [], [], []
    overall_best = (np.inf, None)
    for run in range(args.runs):
        seed = args.seed + run
        model = HierNodeModel(args.layer_name, in_dim=ds.x.shape[1],
                              hidden=args.hidden,
                              num_layers=args.num_layers1,
                              out_dim=num_classes if classify else 1,
                              classify=classify)
        model = init_hier_params(model, seed).to(device)
        opt = adam_l2(model.parameters(), args.lr, args.weight_decay)
        gen = torch.Generator(device=device).manual_seed(seed)

        def snapshot():
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}

        best_val, best_state = np.inf, snapshot()
        for epoch in range(args.epochs1):
            hier_train_step(model, opt, x, y, shard.train_mask, rp, gen,
                            task)
            val_loss, _ = hier_eval_step(model, x, y, shard.val_mask, rp,
                                         task)
            if float(val_loss) < best_val or epoch == 0:
                best_val, best_state = float(val_loss), snapshot()
        model.load_state_dict(best_state)
        hier_eval_step(model, x, y, shard.test_mask, rp, task)   # warm-up
        t0 = time.perf_counter()
        test_loss, test_acc = hier_eval_step(model, x, y, shard.test_mask,
                                             rp, task)
        test_loss, test_acc = float(test_loss), float(test_acc)
        all_time.append(time.perf_counter() - t0)
        all_acc.append(test_acc)
        all_loss.append(test_loss)
        if best_val < overall_best[0] or overall_best[1] is None:
            overall_best = (best_val, best_state)
        print(f"distributed baseline run {run} ({H}x{D} mesh, "
              f"{args.layer_name}): test_loss={test_loss:.4f} "
              f"acc={test_acc:.4f}")
    if rank:
        return
    ckpt = checkpoint_path(args.task, args.output_dir, baseline=True)
    save_params(ckpt, overall_best[1])
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
        "exp_setup": f"baseline_dist_{H}x{D}", "layer_name": args.layer_name,
        "extra_nodes": False, "cluster_node": H > 1,
        "community_used": True, "hidden": args.hidden, "runs": args.runs,
        "num_layers": args.num_layers1, "batch_size": args.batch_size,
        "lr": args.lr, "ave_acc": f"{acc.mean()} +/- {acc.std()}",
        "ave_time": float(np.mean(all_time)),
        "top_10_acc": f"{top_acc.mean()} +/- {top_acc.std()}",
        "best_acc": float(top_acc[0]),
        "top_10_loss": f"{top_loss.mean()} +/- {top_loss.std()}",
        "best_loss": float(top_loss[0])})
    R.append_csv_row(f"results/baseline/{args.dataset}.csv", header, row)
    print(f"results/baseline/{args.dataset}.csv <- {row}")


def cmd_train(args) -> int:
    """The FIT-GNN curriculum, as the JAX package's ``cmd_train``: on one
    device, partition (through the cache), the Gc graph Leiden-reordered
    onto the hybrid operator when ``--hybrid_spmm`` lets it, then
    ``run_node_task``; with ``--num_devices P`` the P ranks of
    ``_train_dist_run``.  The last run's best parameters go to
    ``save/<task>/<output_dir>/model.pt``, one row to
    ``results/<dataset>.csv``."""
    from fitgnn_tpu_torch.train.loop import run_node_task
    from fitgnn_tpu_torch.utils.device import resolve_device

    if args.num_devices > 1:
        return _start_ranks(args, _train_dist_run)
    resolve_device(args.device)
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    num_classes = ds.num_classes if args.task == "node_cls" else None
    train, val, test = _splits(args, ds, num_classes)
    part = _partition(args, ds, train, val, test, num_classes)
    coarse = part.coarse
    collapse = args.cluster_attention or args.cluster_aggregation
    if collapse and coarse is None:
        raise SystemExit(_NO_GC_PHASE)
    if coarse is not None and args.exp_setup != "Gs_train_2_Gs_infer":
        from fitgnn_tpu_torch.graph.optimize import (optimize_coarse,
                                                     should_use_hybrid)
        if collapse or should_use_hybrid(int(coarse.graph.n_node),
                                         args.layer_name, args.hybrid_spmm):
            coarse = optimize_coarse(coarse, seed=args.seed,
                                     layer_name=args.layer_name,
                                     min_block_edges=args.hybrid_threshold,
                                     tile_dtype=_tile_dtype(args),
                                     **_cluster_kwargs(args))
            print(f"Gc hybrid operator: "
                  f"{_operator_line(coarse.graph.aux, args.cluster_attention)}")

    cfg = _train_config(args, num_classes, args.device)
    if cfg.resume_path and not args.resume:
        # --checkpoint_every without --resume is a fresh session: a stale
        # checkpoint of an earlier one must not skip its epochs
        shutil.rmtree(cfg.resume_path, ignore_errors=True)
    res = run_node_task(cfg, coarse, part.subgraphs, verbose=True)
    _train_row(args, cfg, res)
    return 0


def _train_config(args, num_classes, device: str):
    """The ``NodeTaskConfig`` of ``train``'s flags on ``device``: under
    ``--num_devices P`` the mesh, and the cluster flags as the hier Gc
    phase's interior collapse (``gc_cluster``, ``gc_cluster_exact``)."""
    from fitgnn_tpu_torch.train.loop import NodeTaskConfig

    task = "classification" if args.task == "node_cls" else "regression"
    save_path = checkpoint_path(args.task, args.output_dir, baseline=False)
    dist = args.num_devices > 1
    return NodeTaskConfig(
        layer_name=args.layer_name, hidden=args.hidden,
        num_layers=args.num_layers1, task=task,
        out_dim=num_classes if task == "classification" else 1,
        exp_setup=args.exp_setup, epochs1=args.epochs1,
        epochs2=args.epochs2, lr=args.lr, lr2=args.lr2,
        weight_decay=args.weight_decay,
        gradient_method=args.gradient_method, batch_size=args.batch_size,
        loss_reduction=args.loss_reduction, runs=args.runs, seed=args.seed,
        logdir=os.path.dirname(save_path), save_path=save_path,
        run_intermediate_inference=args.run_intermediate_inference,
        intermediate_inference_freq=args.intermediate_inference_freq,
        intermediate_csv_path=(
            f"results/{args.dataset}_intermediate_inference.csv"
            if args.run_intermediate_inference else None),
        early_stopping=args.early_stopping,
        chunk_elem_budget=args.chunk_budget, eval_chunk=args.eval_chunk,
        fused_epochs=args.fused_epochs,
        resume_path=(os.path.join("save", args.task, args.output_dir,
                                  "resume")
                     if (args.resume or args.checkpoint_every) else None),
        checkpoint_every=args.checkpoint_every, device=device,
        num_devices=args.num_devices, num_hosts=args.num_hosts,
        gc_cluster=((args.cluster_attention or args.cluster_aggregation)
                    if dist else 0),
        gc_cluster_exact=((args.cluster_attention_exact
                           or args.cluster_aggregation_exact)
                          if dist else 0))


def _train_row(args, cfg, res) -> None:
    """``train``'s checkpoint line and its ``results/<dataset>.csv``
    row."""
    from fitgnn_tpu_torch.utils import results as R

    print(f"checkpoint saved: {cfg.save_path}")
    s = res.summary
    classify = cfg.task == "classification"
    header = R.TRAIN_NODE_CLS_HEADER if classify else R.TRAIN_NODE_REG_HEADER
    row = R.format_row(header, {
        "dataset": args.dataset, "coarsening_method": args.coarsening_method,
        "coarsening_ratio": args.coarsening_ratio,
        "experiment": args.experiment, "exp_setup": args.exp_setup,
        "layer_name": args.layer_name, "extra_nodes": args.extra_node,
        "cluster_node": args.cluster_node,
        "community_used": args.use_community_detection,
        "hidden": args.hidden, "runs": args.runs,
        "num_layers": args.num_layers1, "batch_size": args.batch_size,
        "lr": args.lr,
        "ave_acc": f"{s['ave_acc']} +/- {s['std_acc']}",
        "ave_time": s["ave_time"],
        "top_10_acc": f"{s['top_10_acc']} +/- {s['top_10_acc_std']}",
        "best_acc": s["best_acc"],
        # node_reg loss columns hold the std-normalized L1, the value the
        # reference records as its regression loss
        "top_10_loss": (
            f"{s['top_10_loss']} +/- {s['top_10_loss_std']}" if classify
            else f"{s['top_10_metric']} +/- {s['top_10_metric_std']}"),
        "best_loss": s["best_loss"] if classify else s["best_metric"]})
    R.append_csv_row(f"results/{args.dataset}.csv", header, row)
    print(f"results/{args.dataset}.csv <- {row}")


def _train_dist_run(args, rank, device) -> None:
    """One rank of ``train --num_devices P`` (the distributed curriculum,
    as the JAX package's ``cmd_train`` runs it under ``--num_devices``):
    rank 0 computes the partition or loads it from the port's cache, then
    the others load it from the cache, so it is computed once; the Gc
    graph keeps its prebuilt weights (the single-device
    ``optimize_coarse`` is skipped: each rank builds its own interior
    operator, so ``--hybrid_threshold`` and ``--hybrid_bf16_tiles`` do not
    reach it, and the cluster flags become the interior's collapse); then
    ``run_node_task`` on this rank's device.  Rank 0 saves the checkpoint
    and appends the row."""
    import torch.distributed as dist
    from fitgnn_tpu_torch.train.loop import run_node_task

    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    num_classes = ds.num_classes if args.task == "node_cls" else None
    train, val, test = _splits(args, ds, num_classes)
    part = None
    if rank == 0:
        part = _partition(args, ds, train, val, test, num_classes)
    dist.barrier()
    if part is None:
        part = _partition(args, ds, train, val, test, num_classes)
    if (args.cluster_attention or args.cluster_aggregation) and \
            part.coarse is None:
        raise SystemExit(_NO_GC_PHASE)
    cfg = _train_config(args, num_classes, str(device))
    if cfg.resume_path and not args.resume:
        # a fresh session: the stale checkpoint goes before any rank reads
        if rank == 0:
            shutil.rmtree(cfg.resume_path, ignore_errors=True)
        dist.barrier()
    res = run_node_task(cfg, part.coarse, part.subgraphs, verbose=True)
    if rank == 0:
        _train_row(args, cfg, res)


def _graph_samples(args, gds, n: Optional[int] = None) -> list:
    """The first ``n`` graphs of ``gds`` (all by default) coarsened into
    ``GraphSample``s: ratio ``1 - coarsening_ratio`` (the reference's
    semantics), the subgraphs in ``_node_mode``; host seconds printed."""
    from fitgnn_tpu_torch.data.graph_level import prepare_graph_sample
    n = len(gds.graphs) if n is None else n
    t0 = time.perf_counter()
    samples = [prepare_graph_sample(
        x, s, r, y_, reduction=1.0 - args.coarsening_ratio,
        method=args.coarsening_method, mode=_node_mode(args), seed=args.seed)
        for (x, s, r), y_ in zip(gds.graphs[:n], gds.y[:n])]
    secs = time.perf_counter() - t0
    print(f"graph samples: {len(samples)} coarsened in {secs:.2f} s host "
          f"({1e3 * secs / max(len(samples), 1):.2f} ms a graph)",
          file=sys.stderr)
    return samples


def _cmd_train_graph(args) -> int:
    """Graph-level training, as the JAX package's ``_cmd_train_graph``:
    every graph coarsened, the 1/2, 1/4, 1/4 split collated in chunks of
    ``--batch_size`` graphs of one shape, then ``run_graph_task``; the best
    parameters go to ``save/<task>/<output_dir>/model.pt``, one row to
    ``results/<dataset>.csv``."""
    from fitgnn_tpu_torch.data.datasets import load_graph_dataset
    from fitgnn_tpu_torch.data.graph_level import collate_graph_level_batches
    from fitgnn_tpu_torch.data.splits import splits_graph_level
    from fitgnn_tpu_torch.train.graph_loop import (GraphTaskConfig,
                                                   run_graph_task)
    from fitgnn_tpu_torch.utils import results as R
    from fitgnn_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    gds = load_graph_dataset(args.dataset, args.data_root)
    classify = args.task == "graph_cls"
    samples = _graph_samples(args, gds)
    t0 = time.perf_counter()
    bt, bv, be = (collate_graph_level_batches([samples[i] for i in idx],
                                              args.batch_size)
                  for idx in splits_graph_level(len(samples),
                                                seed=args.seed))
    print(f"graph collation: {time.perf_counter() - t0:.2f} s host, "
          f"{len(bt)} train chunks of gc {tuple(bt[0].gc.x.shape)}, gs "
          f"{tuple(bt[0].gs.x.shape)}", file=sys.stderr)

    save_path = checkpoint_path(args.task, args.output_dir, baseline=False)
    cfg = GraphTaskConfig(
        layer_name=args.layer_name, hidden=args.hidden,
        num_layers=args.num_layers1,
        out_dim=int(gds.y.max()) + 1 if classify else 1, classify=classify,
        exp_setup=args.exp_setup, epochs1=args.epochs1, epochs2=args.epochs2,
        lr=args.lr, weight_decay=args.weight_decay,
        prop=args.property if args.multi_prop else None, seed=args.seed,
        batch_size=args.batch_size, save_path=save_path, device=args.device)
    res = run_graph_task(cfg, bt, bv, be, verbose=True)
    print(f"checkpoint saved: {save_path}")
    row = R.format_row(R.TRAIN_GRAPH_HEADER, {
        "dataset": args.dataset, "coarsening_method": args.coarsening_method,
        "coarsening_ratio": args.coarsening_ratio,
        "exp_setup": args.exp_setup, "layer_name": args.layer_name,
        "extra_nodes": args.extra_node, "cluster_node": args.cluster_node,
        "community_used": args.use_community_detection,
        "hidden": args.hidden, "num_layers1": args.num_layers1,
        "num_layers2": args.num_layers2, "epochs1": args.epochs1,
        "epochs2": args.epochs2, "batch_size": args.batch_size,
        "lr": args.lr, "best_test_loss": res.best_test_loss,
        "best_test_acc": res.best_test_acc})
    R.append_csv_row(f"results/{args.dataset}.csv", R.TRAIN_GRAPH_HEADER, row)
    print(f"results/{args.dataset}.csv <- {row}")
    return 0


def _cmd_infer_graph(args) -> int:
    """Graph-level inference latency, as the JAX package's
    ``_cmd_infer_graph``: the first ``--num_test_samples`` graphs, the
    checkpoint ``train`` saved, one row for the Gs view (``fitgnn_gs``)
    and one for the Gc view (``fitgnn_gc``) to
    ``inference_results/<task>.csv``."""
    import torch
    from fitgnn_tpu_torch.bench.graph_inference import \
        graph_inference_benchmark
    from fitgnn_tpu_torch.data.datasets import load_graph_dataset
    from fitgnn_tpu_torch.models.models import GraphModel
    from fitgnn_tpu_torch.train.checkpoint import restore_params
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    gds = load_graph_dataset(args.dataset, args.data_root)
    classify = args.task == "graph_cls"
    n = min(args.num_test_samples, len(gds.graphs))
    samples = _graph_samples(args, gds, n)
    depth = args.num_layers2 if args.num_layers2 is not None \
        else args.num_layers1
    model = GraphModel(args.layer_name,
                       in_dim=samples[0].coarse_x.shape[1],
                       hidden=args.hidden, num_layers=depth,
                       out_dim=int(gds.y.max()) + 1 if classify else 1,
                       classify=classify)
    model.reset_parameters(torch.Generator().manual_seed(args.seed))
    ckpt = _resolve_checkpoint(args, baseline=False)
    if ckpt:
        model.load_state_dict(restore_params(ckpt))
    model = model.to(device)
    for view in ("gs", "gc"):
        rep = graph_inference_benchmark(model, samples, gds.y[:n], view=view,
                                        classify=classify)
        _inference_row(args, rep, f"fitgnn_{view}")
    return 0


def _tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a ``Graph`` or ``SubgraphBatch`` (the
    ``None`` fields left out), as the JAX package sums
    ``jtu.tree_leaves``.  The leaves map one to one: a collated chunk's
    ``gc`` holds x (f32), senders, receivers (int32), edge_weight (f32),
    n_node and n_edge (int32, 0-d), its ``gs`` the same with a subgraph
    axis plus consume_mask (bool) and orig_idx (int32), in both packages;
    the labels, which the port holds in int64 where the JAX package holds
    int32, sit in the batch's ``y``, outside both trees."""
    import torch
    return sum(v.numel() * v.element_size() for v in tree
               if isinstance(v, torch.Tensor))


def _memory_row(args, kind: str, mb: float) -> str:
    from fitgnn_tpu_torch.utils import results as R
    row = R.format_row(R.MEMORY_HEADER, {
        "dataset": args.dataset, "coarsening_method": args.coarsening_method,
        "coarsening_ratio": args.coarsening_ratio, "task": args.task,
        "type": f"{kind}:{_node_mode(args)}",
        "max_memory_usage_graphs": f"{mb:.2f}"})
    R.append_csv_row("memory_usage.csv", R.MEMORY_HEADER, row)
    return row


def _cmd_memory_graph(args) -> int:
    """Graph-task memory rows, as the JAX package's ``_cmd_memory_graph``:
    the first chunk's Gs and Gc views at 128 graphs a chunk (MB of 10^6
    bytes, as there) and the largest single molecule's raw arrays, the
    chunk held on the device."""
    from fitgnn_tpu_torch.data.datasets import load_graph_dataset
    from fitgnn_tpu_torch.data.graph_level import collate_graph_level_batches
    from fitgnn_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    gds = load_graph_dataset(args.dataset, args.data_root)
    chunks = collate_graph_level_batches(
        _graph_samples(args, gds), getattr(args, "batch_size", 0) or 128)
    b0 = chunks[0].to(device)
    biggest = max(gds.graphs, key=lambda g: g[0].shape[0])
    big_mb = (biggest[0].nbytes + biggest[1].nbytes + biggest[2].nbytes) / 1e6
    for kind, val in (("chunk_gs", _tree_bytes(b0.gs) / 1e6),
                      ("chunk_gc", _tree_bytes(b0.gc) / 1e6),
                      ("max_graph", big_mb)):
        print(f"memory_usage.csv <- {_memory_row(args, kind, val)}")
    return 0


def cmd_memory(args) -> int:
    """The full graph's and the largest subgraph's footprint, as the JAX
    package's ``cmd_memory``: the partition through the cache, both held
    on the device, one row each to ``memory_usage.csv`` with ``real_mb``
    (the padded MB printed beside it)."""
    from fitgnn_tpu_torch.bench.memory import memory_report
    from fitgnn_tpu_torch.graph.build import build_graph
    from fitgnn_tpu_torch.graph.container import SubgraphBatch
    from fitgnn_tpu_torch.utils.device import resolve_device

    if args.task in GRAPH_TASKS:
        return _cmd_memory_graph(args)
    device = resolve_device(args.device)
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    num_classes = ds.num_classes if args.task == "node_cls" else None
    train, val, test = _splits(args, ds, num_classes)
    part = _partition(args, ds, train, val, test, num_classes)
    g = build_graph(ds.x, ds.senders, ds.receivers).to(device)
    sub = part.subgraphs
    sub = (sub.to(device) if isinstance(sub, SubgraphBatch)
           else tuple(b.to(device) for b in sub))
    for r in memory_report(g, sub):
        row = _memory_row(args, r.kind, r.real_mb)
        print(f"memory_usage.csv <- {row}  (padded: {r.padded_mb:.2f} MB)")
    return 0


def cmd_stats(args) -> int:
    """One ``dataset_info.csv`` row, as the JAX package's ``cmd_stats``
    (host numpy; ``--device`` is checked as on every subcommand)."""
    from fitgnn_tpu_torch.data.stats import DatasetStats, node_dataset_stats
    from fitgnn_tpu_torch.utils.results import append_csv_row
    from fitgnn_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    ds = _load_node(args)
    st = node_dataset_stats(args.dataset, ds.x, ds.senders, ds.receivers,
                            ds.y, classification=args.task == "node_cls")
    append_csv_row("dataset_info.csv", DatasetStats.CSV_HEADER, st.csv_row())
    print(st.csv_row())
    return 0


def cmd_save_graphs(args) -> int:
    """Warm the port's partition-artifact cache, as the JAX package's
    ``cmd_save_graphs`` (``_partition`` loads or computes)."""
    from fitgnn_tpu_torch.graph.container import SubgraphBatch
    from fitgnn_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)
    ds = _load_node(args)
    _apply_auto_config(args, ds.num_nodes)
    num_classes = ds.num_classes if args.task == "node_cls" else None
    train, val, test = _splits(args, ds, num_classes)
    part = _partition(args, ds, train, val, test, num_classes)
    if isinstance(part.subgraphs, SubgraphBatch):
        desc = f"{part.subgraphs.num_subgraphs} subgraphs"
    else:
        desc = (f"{sum(b.num_subgraphs for b in part.subgraphs)} subgraphs "
                f"in {len(part.subgraphs)} size buckets "
                f"{[b.num_nodes_padded for b in part.subgraphs]}")
    print(f"partition artifacts cached ({part.num_metanodes} metanodes, "
          f"{desc})")
    return 0


_NODE_TOOLS = {"memory": cmd_memory, "stats": cmd_stats,
               "save-graphs": cmd_save_graphs}


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    args = arg_correction(args)
    if args.command in _NODE_TOOLS:
        return _NODE_TOOLS[args.command](args)
    if args.command == "train":
        # the JAX package's order: the cluster flags' refusals, then the
        # graph tasks (--baseline included), then the node paths
        _check_cluster_args(args)
        if args.task in GRAPH_TASKS:
            return _cmd_train_graph(args)
        _check_train_args(args)
        return cmd_train_baseline(args) if args.baseline else cmd_train(args)
    if args.task in GRAPH_TASKS:       # infer and infer-baseline alike
        return _cmd_infer_graph(args)
    if args.command == "infer":
        return cmd_infer(args)
    return cmd_infer_baseline(args)


if __name__ == "__main__":
    raise SystemExit(main())
