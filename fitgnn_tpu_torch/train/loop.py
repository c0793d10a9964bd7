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

Not ported yet: ``num_devices > 1``, which raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import List, Optional

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
    device: str = "cuda"                  # "cpu" only when asked
    num_devices: int = 1                  # >1 (the distributed
                                          # curriculum) is not ported yet


def _check_config(cfg: NodeTaskConfig) -> None:
    if cfg.num_devices > 1:
        raise NotImplementedError(
            "run_node_task: num_devices > 1 (the distributed curriculum) is "
            "not ported yet: ROADMAP.md §1 item 4 (distributed paths); "
            "train --baseline --num_devices N runs the distributed "
            "baseline")
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


def run_node_task(cfg: NodeTaskConfig, coarse: Optional[CoarseData],
                  batch, verbose: bool = False) -> TaskResult:
    """Run ``cfg.runs`` runs of ``cfg.exp_setup`` on ``cfg.device``.

    ``coarse`` and ``batch`` are the partition's CPU tensors; ``batch`` is
    one ``SubgraphBatch`` or a sequence of size-bucketed ones (GD and eval
    give the same result either way).  They move to the device once.  Each
    run starts from ``reset_parameters`` drawn from a generator seeded with
    ``seed + run``, and its dropout draws from a generator with the same
    seed on the device.  With ``resume_path`` a checkpoint found there is
    taken up first (completed runs are skipped, the run it was written in
    goes on from its epoch), and the session's state is saved there at
    each phase boundary, every ``checkpoint_every`` epochs and after each
    run."""
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
    batches = tuple(b.to(device) for b in batches)
    if coarse is not None:
        coarse = coarse.to(device)
    task = cfg.task
    use_gc = cfg.exp_setup in ("Gc_train_2_Gs_infer", "Gc_train_2_Gs_train")
    use_gs = cfg.exp_setup in ("Gs_train_2_Gs_infer", "Gc_train_2_Gs_train")
    fp = _config_fp(cfg)

    def vprint(msg):
        if verbose:
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
            if cfg.resume_path is not None:
                ckpt.save_resume(
                    cfg.resume_path, model, opt, best_state, best_val, gen,
                    phase, epoch, run,
                    [[r.test_loss, r.test_acc, r.test_time]
                     for r in results],
                    since_best=since_best, config_fp=fp)

        writer = None
        if cfg.logdir is not None:
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
            if cfg.fused_epochs and not cfg.early_stopping:
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
                    train_loss = steps.gc_train_step(
                        model, opt, coarse.graph, coarse.y_train,
                        coarse.train_mask, gen, task,
                        reduction=cfg.loss_reduction)
                    val_loss, _ = steps.gc_eval_step(
                        model, coarse.graph, coarse.y_val, coarse.val_mask,
                        task)
                    val_loss = float(val_loss)
                    t_ep1 = time.perf_counter()
                    gc_times.append(t_ep1 - t_ep0)
                    t_ep0 = t_ep1
                    log("Gc_train_loss", float(train_loss), epoch)
                    log("Gc_val_loss", val_loss, epoch)
                    if epoch < 2 or epoch % 10 == 0:
                        vprint(f"[Gc] epoch {epoch}: val={val_loss:.4f}"
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
                    vprint(f"[Gc] first epoch {gc_times[0]:.3f}s, steady "
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
                train_loss = float(_gs_train_epoch(model, opt, batches, gen,
                                                   cfg))
                val_loss, val_acc = _gs_eval(model, batches, cfg, "val")
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
                    t_loss, t_acc = _gs_eval(model, batches, cfg, "test")
                    t_time = time.perf_counter() - t0
                    model.load_state_dict(current)
                    log("Gs_test_loss_intermediate", t_loss, epoch)
                    log("Gs_test_acc_intermediate", t_acc, epoch)
                    if cfg.intermediate_csv_path is not None:
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
        _gs_eval(model, batches, cfg, "test")
        t0 = time.perf_counter()
        test_loss, test_metric = _gs_eval(model, batches, cfg, "test")
        elapsed = time.perf_counter() - t0
        results.append(RunResult(test_loss=test_loss, test_acc=test_metric,
                                 test_time=elapsed,
                                 gc_epoch_seconds=gc_times,
                                 gs_epoch_seconds=gs_times,
                                 gc_fused_seconds=gc_fused_s))
        if cfg.save_path is not None:
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
