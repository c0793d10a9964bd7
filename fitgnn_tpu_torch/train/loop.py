"""Experiment-setup orchestration for node tasks (one device).

The port of the JAX package's ``train/loop.py``: per-run model init, the
three experiment setups —

* ``Gc_train_2_Gs_infer``  — train on the coarse graph (best-val Gc
  parameters), infer on the subgraphs,
* ``Gs_train_2_Gs_infer``  — train on the subgraphs directly,
* ``Gc_train_2_Gs_train``  — coarse pre-training, then subgraph
  fine-tuning from the best Gc parameters (the optimizer state carries
  over, as the JAX package's ``state.replace(params=…)`` keeps it, unless
  ``lr2`` starts a fresh one),

with best-validation tracking in both phases, GD/MB gradient modes on one
subgraph batch or on size-bucketed batches, early stopping, the
intermediate-inference CSV, and a warm-up then timed Gs test eval per run.
``fused_epochs`` runs the Gc phase without reading a value back until it
ends (ignored under ``early_stopping``, which needs each val loss, as the
JAX package ignores it); ``eval_chunk`` evaluates the subgraphs in slices;
``resume_path`` / ``checkpoint_every`` save the session's state and take
a killed session up where its last save left it.  Multi-run statistics
(mean, top-10, best) match the reference's reporting.

``num_devices = P > 1`` runs the distributed curriculum, as the JAX
package's ``run_node_task`` does, in an initialized process group of P
ranks, each calling ``run_node_task`` with its own device: the Gs phase
sharded over the subgraph axis (``parallel/dist_subgraphs.py``), the Gc
phase over a ``num_hosts`` × chips hierarchical mesh
(``_make_hier_gc_steps``; it comes before ``fused_epochs``, which is then
ignored).  Every rank takes the same host-side decisions, from values
summed over the ranks; rank 0 alone logs, writes the intermediate CSV,
saves the parameters and the resume checkpoint (a barrier after each
save), and prints.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from fitgnn_tpu_torch.graph.container import SubgraphBatch
from fitgnn_tpu_torch.models.models import NodeModel
from fitgnn_tpu_torch.partition.pipeline import CoarseData
from fitgnn_tpu_torch.train import checkpoint as ckpt
from fitgnn_tpu_torch.train import steps
from fitgnn_tpu_torch.utils.device import resolve_device

EXP_SETUPS = ("Gc_train_2_Gs_infer", "Gs_train_2_Gs_infer",
              "Gc_train_2_Gs_train")


@dataclasses.dataclass
class RunResult:
    test_loss: float
    test_acc: float
    test_time: float
    # wall seconds of each epoch (train step(s) + val eval, to the value)
    gc_epoch_seconds: List[float] = dataclasses.field(default_factory=list)
    gs_epoch_seconds: List[float] = dataclasses.field(default_factory=list)
    # the fused Gc phase: wall seconds of all its epochs, from the call to
    # the values read back (it has no per-epoch times)
    gc_fused_seconds: Optional[float] = None


@dataclasses.dataclass
class TaskResult:
    runs: List[RunResult]

    @property
    def summary(self) -> dict:
        accs = np.array([r.test_acc for r in self.runs])
        losses = np.array([r.test_loss for r in self.runs])
        times = np.array([r.test_time for r in self.runs])
        top_acc = np.sort(accs)[::-1][:10]
        top_loss = np.sort(losses)[:10]
        return {
            "ave_acc": float(accs.mean()), "std_acc": float(accs.std()),
            "ave_time": float(times.mean()),
            "top_10_acc": float(top_acc.mean()),
            "top_10_acc_std": float(top_acc.std()),
            "best_acc": float(top_acc[0]) if len(top_acc) else 0.0,
            "top_10_loss": float(top_loss.mean()),
            "top_10_loss_std": float(top_loss.std()),
            "best_loss": float(top_loss[0]) if len(top_loss) else 0.0,
            # regression: test_acc holds the std-normalized L1, the value
            # the reference records as its regression loss; sorted
            # ascending (lower = better) for the node_reg CSV loss columns
            "top_10_metric": float(np.sort(accs)[:10].mean()),
            "top_10_metric_std": float(np.sort(accs)[:10].std()),
            "best_metric": float(np.sort(accs)[0]) if len(accs) else 0.0,
        }


@dataclasses.dataclass
class NodeTaskConfig:
    layer_name: str = "GCNConv"
    hidden: int = 512
    num_layers: int = 2
    task: str = "classification"          # or "regression"
    out_dim: int = 2                      # num_classes or 1
    exp_setup: str = "Gc_train_2_Gs_infer"
    epochs1: int = 100
    epochs2: int = 300
    lr: float = 0.01
    lr2: Optional[float] = None           # Gs-phase learning rate (None =
                                          # lr); a different one starts a
                                          # fresh optimizer at the boundary
    weight_decay: float = 5e-4
    gradient_method: str = "GD"           # or "MB"
    loss_reduction: str = "mean"          # or "sum" (reference flag; GD
                                          # over several buckets always
                                          # means, as the JAX package's)
    batch_size: int = 128                 # subgraphs per MB optimizer step
    runs: int = 1
    seed: int = 0
    logdir: Optional[str] = None          # scalar JSONL per run
    run_intermediate_inference: bool = False
    intermediate_inference_freq: int = 10
    save_path: Optional[str] = None       # best-val state dict (model.pt)
    intermediate_csv_path: Optional[str] = None  # epoch,test_loss,
                                          # test_acc,test_time per check
    early_stopping: int = 0               # patience in epochs on the val
                                          # loss; 0 = off
    chunk_elem_budget: int = 1 << 28      # caps the MB chunk and the eval
                                          # chunk of a batch at
                                          # budget / (E_pad · hidden)
    eval_chunk: int = 0                   # >0: the Gs eval runs slices of
                                          # this many subgraphs in turn
                                          # (per bucket, capped as above)
    fused_epochs: bool = False            # the Gc phase without a host
                                          # read per epoch (not under
                                          # early_stopping)
    resume_path: Optional[str] = None     # directory of the resume
                                          # checkpoint; loaded if present
    checkpoint_every: int = 0             # epochs between resume saves
                                          # (0 = phase and run boundaries)
    device: str = "cuda"                  # "cpu" only when asked; a
                                          # rank's own card (cuda:r) under
                                          # num_devices > 1
    num_devices: int = 1                  # >1: the ranks of the process
                                          # group; the Gs phase sharded over
                                          # the subgraph axis, the Gc phase
                                          # over the hierarchical mesh
    num_hosts: int = 1                    # with num_devices > 1: the Gc
                                          # mesh as (hosts × chips), exact
                                          # halo within a host, cluster
                                          # summaries across hosts
    gc_cluster: int = 0                   # with num_devices > 1: each
                                          # rank's interior stragglers
                                          # collapsed onto summaries of K
                                          # nodes (snapped to a divisor of
                                          # the padded shard)
    gc_cluster_exact: int = 0             # the top-k straggler senders that
                                          # keep the exact per-edge path
    distributed: bool = False             # the distributed path at
                                          # num_devices = 1 too (a one-rank
                                          # world); above 1 it is the only
                                          # path


def _check_config(cfg: NodeTaskConfig) -> None:
    if cfg.num_devices > 1 and cfg.num_devices % cfg.num_hosts:
        raise ValueError(f"num_devices {cfg.num_devices} must divide by "
                         f"num_hosts {cfg.num_hosts}")
    if cfg.exp_setup not in EXP_SETUPS:
        raise ValueError(f"exp_setup must be one of {EXP_SETUPS}")
    if cfg.gradient_method not in ("GD", "MB"):
        raise ValueError(f"unknown gradient_method {cfg.gradient_method!r}"
                         " (GD or MB)")


def _config_fp(cfg: NodeTaskConfig) -> int:
    """The fingerprint of what shapes a session's stream, as the JAX
    package's: a resume under another schedule or model raises."""
    key = (cfg.seed, cfg.epochs1, cfg.epochs2, cfg.runs, cfg.exp_setup,
           cfg.gradient_method, cfg.batch_size, cfg.layer_name,
           cfg.hidden, cfg.num_layers, cfg.task, cfg.lr,
           cfg.weight_decay, cfg.loss_reduction, cfg.early_stopping)
    return zlib.crc32(repr(key).encode())


def _chunk_cap(cfg: NodeTaskConfig, batch: SubgraphBatch) -> int:
    """Largest chunk of subgraphs whose (chunk, E_pad, hidden) per-edge
    message size stays inside ``cfg.chunk_elem_budget`` elements."""
    e_pad = batch.senders.shape[-1]
    return max(1, cfg.chunk_elem_budget // max(1, e_pad * cfg.hidden))


def _gs_train_epoch(model, opt, batches, gen, cfg: NodeTaskConfig):
    """One Gs epoch: GD one step (over every bucket), MB a step a chunk,
    bucket by bucket, each bucket's chunk capped by its own ``E_pad``.
    Returns the loss (a tensor)."""
    task = cfg.task
    if cfg.gradient_method == "GD":
        if len(batches) == 1:
            return steps.gs_train_step_gd(model, opt, batches[0], gen, task,
                                          reduction=cfg.loss_reduction)
        return steps.gs_train_step_gd_multi(model, opt, batches, gen, task)
    total = 0.0
    for b in batches:
        bs = min(cfg.batch_size, b.num_subgraphs, _chunk_cap(cfg, b))
        total = total + steps.gs_train_epoch_mb(
            model, opt, b, gen, task, batch_size=bs,
            reduction=cfg.loss_reduction)
    return total


def _gs_eval(model, batches, cfg: NodeTaskConfig, split: str) -> tuple:
    """(loss, metric) as floats over every batch's consuming ``split``
    nodes; with ``eval_chunk`` each bucket's sums in slices of
    ``min(eval_chunk, its chunk cap)`` subgraphs."""
    if cfg.eval_chunk:
        return steps.finish_eval_from_sums(cfg.task, [
            steps.gs_eval_bucket_sums(
                model, b, cfg.task, split,
                chunk=min(cfg.eval_chunk, _chunk_cap(cfg, b)))
            for b in batches])
    if len(batches) == 1:
        loss, metric = steps.gs_eval_step(model, batches[0], cfg.task, split)
    else:
        loss, metric = steps.gs_eval_step_multi(model, batches, cfg.task,
                                                split)
    return float(loss), float(metric)


def _dist_rank(cfg: NodeTaskConfig) -> int:
    """This rank's index in the process group of ``cfg.num_devices``
    ranks that the distributed curriculum runs in."""
    import torch.distributed as dist
    P = cfg.num_devices
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"num_devices={P} runs in an initialized process group of {P} "
            "ranks (parallel.initialize_distributed), one run_node_task a "
            "rank; train --num_devices starts them")
    if dist.get_world_size() != P:
        raise ValueError(f"num_devices={P} but the process group has "
                         f"{dist.get_world_size()} ranks")
    return dist.get_rank()


def _make_dist_steps(cfg: NodeTaskConfig, batches, device) -> tuple:
    """The subgraph-axis sharded Gs steps of the JAX package's
    ``_make_dist_steps``: this rank's slice of every batch on ``device``,
    MB's global chunk ``min(batch_size, chunk cap · P)`` over every
    bucket.  Returns ``(train(model, opt, generator) -> loss,
    evaluate(model, split) -> (loss, metric) floats)``."""
    import torch.distributed as dist
    from fitgnn_tpu_torch.parallel.dist_subgraphs import (
        dist_gs_eval_step, dist_gs_train_epoch_mb, dist_gs_train_step_gd,
        shard_batches)

    P = cfg.num_devices
    local = shard_batches(batches, dist.get_rank(), P, device)
    if cfg.gradient_method == "MB":
        bs = min(cfg.batch_size, *(_chunk_cap(cfg, b) * P for b in batches))

        def train(model, opt, gen):
            return dist_gs_train_epoch_mb(model, opt, local, gen, cfg.task,
                                          bs, P)
    else:
        def train(model, opt, gen):
            return dist_gs_train_step_gd(model, opt, local, gen, cfg.task)

    def evaluate(model, split):
        loss, metric = dist_gs_eval_step(model, local, cfg.task, split)
        return float(loss), float(metric)

    return train, evaluate


@dataclasses.dataclass
class HierGcPlan:
    """The host side of the distributed Gc phase, the same on every rank:
    the coarse graph's community placement, sharded under the layer's
    weights, its val labels on the same placement, the (shard, community)
    clusters, the interior collapse's cluster size and the exchange
    plan."""

    order: np.ndarray                 # node order of the placement
    cluster_of: np.ndarray            # (P · n_loc,) cluster of each slot
    cluster_size: int                 # K after the snap (0: no collapse)
    sg: object                        # parallel.shard.ShardedGraph
    y_val: np.ndarray                 # (P, n_loc) coarse val labels
    plan: object                      # parallel.hierarchical.HierPlan


def hier_gc_plan(cfg: NodeTaskConfig, coarse: CoarseData) -> HierGcPlan:
    """The JAX package's ``_make_hier_gc_steps`` up to the plan: the
    layer's aggregation weights on the coarse graph, Leiden on its real
    non-self edges (``seed``), community placement onto the P shards,
    ``shard_prebuilt_graph``, clusters from (shard, community) pairs,
    ``gc_cluster`` snapped to the largest multiple of 128 that divides the
    padded shard (with the JAX package's warning), and ``build_hier_plan``
    with each rank's interior on the hybrid operator at its default
    threshold of 150."""
    from fitgnn_tpu_torch.graph.optimize import (_LAYER_SEMANTICS,
                                                 _operator_weights)
    from fitgnn_tpu_torch.parallel.hierarchical import build_hier_plan
    from fitgnn_tpu_torch.parallel.multihost import placement_by_community
    from fitgnn_tpu_torch.parallel.shard import (shard_node_array,
                                                 shard_prebuilt_graph)
    from fitgnn_tpu_torch.partition.community import leiden_communities

    H, P = cfg.num_hosts, cfg.num_devices
    ln = cfg.layer_name
    if ln not in _LAYER_SEMANTICS:
        raise ValueError(f"unknown layer {ln!r} for the distributed Gc phase")
    g = coarse.graph

    def host(t):
        return t.detach().cpu().numpy()

    s = host(g.senders).astype(np.int64)
    r = host(g.receivers).astype(np.int64)
    w = host(g.edge_weight).astype(np.float32)
    real = np.arange(len(s)) < int(g.n_edge)
    nonself = real & (s != r)
    # padding edges are weight-0 self-loops on the pad node, the
    # convention _operator_weights keeps
    wl = _operator_weights(s, r, w, g.num_nodes_padded, _LAYER_SEMANTICS[ln])
    x = host(g.x)
    labels = leiden_communities(s[nonself], r[nonself], x.shape[0],
                                seed=cfg.seed)
    order, _ = placement_by_community(labels, P)
    sg = shard_prebuilt_graph(x, s, r, wl, host(coarse.y_train), P,
                              train_mask=host(coarse.train_mask),
                              val_mask=host(coarse.val_mask), order=order)
    n_loc, n_pad = sg.nodes_per_shard, sg.num_nodes_global
    # the val labels on the same placement as sg
    y_val = shard_node_array(host(coarse.y_val), P, n_loc, order=order)
    lab = np.concatenate([labels[order], np.full(
        n_pad - len(order), labels.max() + 1, dtype=np.int64)])
    pair = (np.arange(n_pad) // n_loc) * (int(lab.max()) + 2) + lab
    _, cluster_of = np.unique(pair, return_inverse=True)
    K = cfg.gc_cluster
    n_pad_shard = -(-n_loc // 128) * 128
    if K and n_pad_shard % K:
        # the padded shard is set by the partition, not the user: the
        # largest 128-multiple divisor of it at most K
        nb = n_pad_shard // 128
        cands = [128 * d for d in range(1, nb + 1)
                 if nb % d == 0 and 128 * d <= K]
        newk = max(cands) if cands else 128 if n_pad_shard % 128 == 0 else 0
        print(f"warning: interior cluster size {K} does not divide the "
              f"per-shard padded node count {n_pad_shard}; using {newk}")
        K = newk
    plan = build_hier_plan(sg.senders, sg.receivers, sg.edge_weight, H,
                           P // H, n_loc, cluster_of, interior_hybrid=True,
                           interior_semantics=_LAYER_SEMANTICS[ln],
                           interior_cluster=K,
                           interior_cluster_exact=cfg.gc_cluster_exact)
    return HierGcPlan(order=order, cluster_of=cluster_of, cluster_size=K,
                      sg=sg, y_val=y_val, plan=plan)


class HierGcSteps(NamedTuple):
    """The distributed Gc phase of one rank: ``train(model, opt,
    generator) -> loss`` and ``evaluate(model) -> (loss, metric)`` for a
    ``HierNodeModel``, with the rank's ``RankPlan`` and the host side."""

    train: Callable
    evaluate: Callable
    rank_plan: object
    host: HierGcPlan


def _make_hier_gc_steps(cfg: NodeTaskConfig, coarse: CoarseData,
                        device) -> HierGcSteps:
    """The distributed Gc phase of the JAX package's
    ``_make_hier_gc_steps``: ``hier_gc_plan``, the (num_hosts × chips)
    mesh, this rank's plan slice, interior operator and shard on
    ``device``."""
    from fitgnn_tpu_torch.parallel.hierarchical import (hier_eval_step,
                                                        hier_train_step)
    from fitgnn_tpu_torch.parallel.mesh import make_hier_mesh

    hg = hier_gc_plan(cfg, coarse)
    mesh = make_hier_mesh(cfg.num_hosts, cfg.num_devices // cfg.num_hosts)
    rp = hg.plan.local(mesh, device)
    shard = hg.sg.local(mesh.rank, device)
    yv = hg.y_val[mesh.rank]
    y_val = torch.from_numpy(np.ascontiguousarray(yv.astype(
        np.int64 if np.issubdtype(yv.dtype, np.integer) else np.float32))
    ).to(device)
    task = cfg.task

    def train(model, opt, gen):
        return hier_train_step(model, opt, shard.x, shard.y,
                               shard.train_mask, rp, gen, task)

    def evaluate(model):
        return hier_eval_step(model, shard.x, y_val, shard.val_mask, rp,
                              task)

    return HierGcSteps(train, evaluate, rp, hg)


def run_node_task(cfg: NodeTaskConfig, coarse: Optional[CoarseData],
                  batch, verbose: bool = False) -> TaskResult:
    """Run ``cfg.runs`` runs of ``cfg.exp_setup`` on ``cfg.device``.

    ``coarse`` and ``batch`` are the partition's CPU tensors; ``batch`` is
    one ``SubgraphBatch`` or a sequence of size-bucketed ones (GD and eval
    give the same result either way).  They move to the device once (under
    ``num_devices > 1`` this rank's shards alone).  Each run starts from
    ``reset_parameters`` drawn from a generator seeded with ``seed + run``,
    and its dropout draws from a generator with the same seed on the
    device.  With ``resume_path`` a checkpoint found there is taken up
    first (completed runs are skipped, the run it was written in goes on
    from its epoch), and the session's state is saved there at each phase
    boundary, every ``checkpoint_every`` epochs and after each run."""
    _check_config(cfg)
    if cfg.exp_setup != "Gs_train_2_Gs_infer" and coarse is None:
        raise ValueError(f"{cfg.exp_setup} requires a coarse graph")
    batches = ((batch,) if isinstance(batch, SubgraphBatch)
               else tuple(batch))
    if not batches or not all(isinstance(b, SubgraphBatch)
                              for b in batches):
        raise TypeError("run_node_task: batch must be a SubgraphBatch or a "
                        "non-empty sequence of them")
    device = resolve_device(cfg.device)
    task = cfg.task
    use_gc = cfg.exp_setup in ("Gc_train_2_Gs_infer", "Gc_train_2_Gs_train")
    use_gs = cfg.exp_setup in ("Gs_train_2_Gs_infer", "Gc_train_2_Gs_train")
    distributed = cfg.num_devices > 1 or cfg.distributed
    hier = None
    if distributed:
        import torch.distributed as dist
        from fitgnn_tpu_torch.parallel.hierarchical import hier_view
        rank = _dist_rank(cfg)
        gs_train, gs_eval = _make_dist_steps(cfg, batches, device)
        if use_gc:
            # the Gc phase on the hierarchical mesh: the whole curriculum
            # runs distributed
            hier = _make_hier_gc_steps(cfg, coarse, device)
            hyb = hier.rank_plan.int_hybrid
            tiles = 0 if hyb.bsr is None else hyb.bsr.nnz_blocks
            if verbose and rank == 0:
                print(f"[Gc hier] {cfg.num_hosts}x"
                      f"{cfg.num_devices // cfg.num_hosts} mesh, rank 0 "
                      f"interior: {tiles} dense tiles, {hyb.num_coo_edges} "
                      "straggler edges", flush=True)
    else:
        rank = 0
        batches = tuple(b.to(device) for b in batches)
        if coarse is not None:
            coarse = coarse.to(device)

        def gs_train(model, opt, gen):
            return _gs_train_epoch(model, opt, batches, gen, cfg)

        def gs_eval(model, split):
            return _gs_eval(model, batches, cfg, split)
    lead = rank == 0
    fp = _config_fp(cfg)

    def vprint(msg):
        if verbose and lead:
            print(msg, flush=True)

    results: List[RunResult] = []
    skip_runs, cursor = 0, None
    if cfg.resume_path is not None:
        point = ckpt.load_resume(cfg.resume_path, config_fp=fp)
        if point is not None:
            results = [RunResult(*row) for row in point.done]
            skip_runs = point.run
            if point.epoch >= 0 or point.phase == "gs":
                cursor = point
            # else the run-complete marker: the next run starts fresh, as
            # in an uninterrupted session
            vprint(f"[resume] run {point.run} {point.phase} epoch "
                   f"{point.epoch + 1} ({len(results)} runs done)")

    for run in range(skip_runs, cfg.runs):
        here, cursor = cursor, None
        seed = cfg.seed + run
        model = NodeModel(cfg.layer_name, in_dim=batches[0].x.shape[-1],
                          hidden=cfg.hidden, num_layers=cfg.num_layers,
                          out_dim=cfg.out_dim,
                          classify=task == "classification")
        model.reset_parameters(torch.Generator().manual_seed(seed))
        model = model.to(device)
        opt = steps.adam_l2(model.parameters(), cfg.lr, cfg.weight_decay)
        gen = torch.Generator(device=device).manual_seed(seed)

        def snapshot():
            return {k: v.detach().clone()
                    for k, v in model.state_dict().items()}

        best_state, best_val = snapshot(), np.inf
        if here is not None:
            model.load_state_dict(here.model)
            if (here.phase == "gs" and cfg.lr2 is not None
                    and cfg.lr2 != cfg.lr):
                opt = steps.adam_l2(model.parameters(), cfg.lr2,
                                    cfg.weight_decay)
            opt.load_state_dict(here.optimizer)
            gen.set_state(here.generator)
            best_state = {k: v.to(device)
                          for k, v in here.best_state.items()}
            best_val = here.best_val

        def save_resume(phase, epoch, since_best=0, run=run):
            if cfg.resume_path is None:
                return
            if lead:
                ckpt.save_resume(
                    cfg.resume_path, model, opt, best_state, best_val, gen,
                    phase, epoch, run,
                    [[r.test_loss, r.test_acc, r.test_time]
                     for r in results],
                    since_best=since_best, config_fp=fp)
            if distributed:
                # no rank goes on before the checkpoint is whole
                dist.barrier()

        writer = None
        if cfg.logdir is not None and lead:
            from fitgnn_tpu_torch.utils.logging import ScalarWriter
            writer = ScalarWriter(cfg.logdir, run=run + 1)
            if here is not None:
                # the dead session logged the epochs about to be replayed
                writer.trim_replay("Gs_" if here.phase == "gs" else "Gc_",
                                   here.epoch + 1,
                                   gc_done=here.phase == "gs")

        def log(tag, value, step):
            if writer is not None:
                writer.add_scalar(tag, value, step)

        gc_times: List[float] = []
        gc_fused_s = None
        if use_gc and (here is None or here.phase == "gc"):
            start, since_best = ((here.epoch + 1, here.since_best)
                                 if here is not None else (0, 0))
            if hier is not None:
                # the hier model is a view of the Gs model's layers, so the
                # Gc phase steps the same parameters and optimizer
                hmodel, tag = hier_view(model), "[Gc hier]"

                def gc_epoch():
                    train_loss = hier.train(hmodel, opt, gen)
                    return train_loss, hier.evaluate(hmodel)[0]
            else:
                tag = "[Gc]"

                def gc_epoch():
                    train_loss = steps.gc_train_step(
                        model, opt, coarse.graph, coarse.y_train,
                        coarse.train_mask, gen, task,
                        reduction=cfg.loss_reduction)
                    return train_loss, steps.gc_eval_step(
                        model, coarse.graph, coarse.y_val, coarse.val_mask,
                        task)[0]
            if hier is None and cfg.fused_epochs and not cfg.early_stopping:
                t0 = time.perf_counter()
                best_state, best_v, tr, vl = steps.gc_train_epochs_fused(
                    model, opt, coarse.graph, coarse.y_train,
                    coarse.train_mask, coarse.y_val, coarse.val_mask, gen,
                    cfg.epochs1 - start, task, reduction=cfg.loss_reduction,
                    best_state=best_state, best_val=best_val)
                best_val, tr, vl = float(best_v), tr.tolist(), vl.tolist()
                gc_fused_s = time.perf_counter() - t0
                for epoch, (t_loss, v_loss) in enumerate(zip(tr, vl),
                                                         start):
                    log("Gc_train_loss", t_loss, epoch)
                    log("Gc_val_loss", v_loss, epoch)
                vprint(f"[Gc fused] {len(vl)} epochs: best_val="
                       f"{best_val:.4f} {gc_fused_s:.3f}s "
                       f"({gc_fused_s / max(len(vl), 1) * 1e3:.2f} "
                       "ms/epoch)")
            else:
                t_gc = t_ep0 = time.perf_counter()
                for epoch in range(start, cfg.epochs1):
                    train_loss, val_loss = gc_epoch()
                    # every rank's val loss is the same sum over the ranks,
                    # so every rank takes the decisions below alike
                    val_loss = float(val_loss)
                    t_ep1 = time.perf_counter()
                    gc_times.append(t_ep1 - t_ep0)
                    t_ep0 = t_ep1
                    log("Gc_train_loss", float(train_loss), epoch)
                    log("Gc_val_loss", val_loss, epoch)
                    if epoch < 2 or epoch % 10 == 0:
                        vprint(f"{tag} epoch {epoch}: val={val_loss:.4f}"
                               f" {t_ep1 - t_gc:.0f}s")
                    if val_loss < best_val or epoch == 0:
                        best_val, best_state = val_loss, snapshot()
                        since_best = 0
                    else:
                        since_best += 1
                        if (cfg.early_stopping
                                and since_best >= cfg.early_stopping):
                            break
                    if (cfg.checkpoint_every
                            and (epoch + 1) % cfg.checkpoint_every == 0):
                        save_resume("gc", epoch, since_best)
                if len(gc_times) > 1:
                    vprint(f"{tag} first epoch {gc_times[0]:.3f}s, steady "
                           f"{float(np.median(gc_times[1:])):.4f}s/epoch "
                           f"(median of {len(gc_times) - 1})")

        gs_times: List[float] = []
        if use_gs:
            resumed_gs = here is not None and here.phase == "gs"
            start, since_best = ((here.epoch + 1, here.since_best)
                                 if resumed_gs else (0, 0))
            if not resumed_gs:
                if cfg.exp_setup == "Gc_train_2_Gs_train":
                    # weight transfer: on from the best Gc parameters
                    model.load_state_dict(best_state)
                if cfg.lr2 is not None and cfg.lr2 != cfg.lr:
                    # a fresh optimizer at the phase boundary, at the Gs
                    # rate
                    opt = steps.adam_l2(model.parameters(), cfg.lr2,
                                        cfg.weight_decay)
                best_state, best_val = snapshot(), np.inf
                # the phase boundary: a resumed session skips the Gc phase
                save_resume("gs", -1)
            t_gs = t_ep0 = time.perf_counter()
            for epoch in range(start, cfg.epochs2):
                train_loss = float(gs_train(model, opt, gen))
                val_loss, val_acc = gs_eval(model, "val")
                t_ep1 = time.perf_counter()
                gs_times.append(t_ep1 - t_ep0)
                t_ep0 = t_ep1
                vprint(f"[Gs] epoch {epoch}: train={train_loss:.4f} "
                       f"val={val_loss:.4f} acc={val_acc:.4f}"
                       f" {t_ep1 - t_gs:.0f}s")
                log("Gs_train_loss", train_loss, epoch)
                log("Gs_val_loss", val_loss, epoch)
                log("Gs_val_acc", val_acc, epoch)
                if val_loss < best_val or epoch == 0:
                    best_val, best_state, since_best = val_loss, snapshot(), 0
                else:
                    since_best += 1
                    if (cfg.early_stopping
                            and since_best >= cfg.early_stopping):
                        break
                if (cfg.checkpoint_every
                        and (epoch + 1) % cfg.checkpoint_every == 0):
                    save_resume("gs", epoch, since_best)
                if (cfg.run_intermediate_inference
                        and epoch % cfg.intermediate_inference_freq == 0):
                    # a test eval with the best parameters so far; the
                    # training parameters are put back after it
                    current = snapshot()
                    model.load_state_dict(best_state)
                    t0 = time.perf_counter()
                    t_loss, t_acc = gs_eval(model, "test")
                    t_time = time.perf_counter() - t0
                    model.load_state_dict(current)
                    log("Gs_test_loss_intermediate", t_loss, epoch)
                    log("Gs_test_acc_intermediate", t_acc, epoch)
                    if cfg.intermediate_csv_path is not None and lead:
                        from fitgnn_tpu_torch.utils.results import \
                            append_csv_row
                        append_csv_row(
                            cfg.intermediate_csv_path,
                            "epoch,test_loss,test_acc,test_time",
                            f"{epoch},{t_loss},{t_acc},{t_time}")
            if len(gs_times) > 1:
                vprint(f"[Gs] first epoch {gs_times[0]:.2f}s, steady "
                       f"{float(np.median(gs_times[1:])):.3f}s/epoch "
                       f"(median of {len(gs_times) - 1})")

        # test with the best-val parameters: a warm-up, then timed to the
        # value
        model.load_state_dict(best_state)
        gs_eval(model, "test")
        t0 = time.perf_counter()
        test_loss, test_metric = gs_eval(model, "test")
        elapsed = time.perf_counter() - t0
        results.append(RunResult(test_loss=test_loss, test_acc=test_metric,
                                 test_time=elapsed,
                                 gc_epoch_seconds=gc_times,
                                 gs_epoch_seconds=gs_times,
                                 gc_fused_seconds=gc_fused_s))
        if cfg.save_path is not None and lead:
            ckpt.save_params(cfg.save_path, best_state)
        # the run-complete marker, after model.pt: a crash between the two
        # re-runs the save; a resumed session starts the next run fresh
        save_resume("gc", -1, run=run + 1)
        log("Gs_test_loss", test_loss, run)
        log("Gs_test_acc", test_metric, run)
        if writer is not None:
            writer.close()
        vprint(f"run {run}: test_loss={test_loss:.4f} "
               f"metric={test_metric:.4f}")
    return TaskResult(runs=results)
