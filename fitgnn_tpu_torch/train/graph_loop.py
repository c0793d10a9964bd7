"""Graph-level training: the steps and the four experiment setups.

The port of the JAX package's ``train/graph_loop.py`` (the reference's
``graph_classification`` / ``graph_regression`` runners), with its fixes
over the reference kept:

* accuracy is taken over the whole split, not the last batch only;
* ``Gc_train_2_Gs_infer`` hands the best Gc parameters to the Gs view (the
  reference evaluates an untrained Gs model);
* the classification loss is the cross-entropy of the model's
  probabilities (log clamped at 1e-12), not a second softmax on top.

A split is one ``GraphLevelBatch`` or a list of chunks of one shape
(``collate_graph_level_batches``): one optimizer step per train chunk per
epoch.  Dropout draws from a ``torch.Generator`` on the model's device,
seeded anew each epoch from (seed, epoch) in the Gc phase and (seed,
10,000 + epoch) in the Gs phase, as the JAX package folds its key; the
streams themselves differ from JAX's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from fitgnn_tpu_torch.data.graph_level import GraphLevelBatch
from fitgnn_tpu_torch.models.models import GraphModel
from fitgnn_tpu_torch.train import checkpoint as ckpt
from fitgnn_tpu_torch.train.steps import adam_l2
from fitgnn_tpu_torch.utils.device import resolve_device

GRAPH_EXP_SETUPS = ("Gc_train_2_Gc_infer", "Gc_train_2_Gs_infer",
                    "Gs_train_2_Gs_infer", "Gc_train_2_Gs_train")


def _mask_of(batch: GraphLevelBatch) -> torch.Tensor:
    return batch.graph_mask.float()


def _target(y: torch.Tensor, prop: Optional[int]) -> torch.Tensor:
    return y if prop is None else y[:, prop]


def _graph_loss_sums(out, y, mask, classify: bool, prop: Optional[int]):
    """(loss sum, count) over the valid samples of one (possibly padded)
    batch: padding samples contribute nothing."""
    if classify:
        logp = torch.log(out.clamp_min(1e-12))
        picked = logp.gather(-1, y[:, None].long())[:, 0]
        return (-picked * mask).sum(), mask.sum()
    target = _target(y, prop)
    err = (out.reshape(target.shape) - target).abs()
    return (err * mask).sum(), mask.sum()


def _graph_loss(out, y, classify: bool, prop: Optional[int], mask):
    s, c = _graph_loss_sums(out, y, mask, classify, prop)
    return s / c.clamp_min(1.0)


def _graph_metric_sums(out, y, mask, classify: bool, prop: Optional[int]):
    """(metric sum, count): the correct count (classification) or the raw
    L1 sum (regression; the caller divides by the split's label std)."""
    if classify:
        correct = (out.argmax(-1) == y).float()
        return (correct * mask).sum(), mask.sum()
    target = _target(y, prop)
    err = (out.reshape(target.shape) - target).abs()
    return (err * mask).sum(), mask.sum()


def _forward(model: GraphModel, batch: GraphLevelBatch, view: str,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if view == "gc":
        return model(batch.gc.x, batch.gc, batch.gc_graph_ids,
                     batch.num_graphs, generator)
    return model.forward_subgraphs(batch.gs, batch.gs_graph_ids,
                                   batch.num_graphs, generator)


def graph_train_step(model: GraphModel, opt: torch.optim.Optimizer,
                     batch: GraphLevelBatch,
                     generator: Optional[torch.Generator], classify: bool,
                     prop: Optional[int], view: str) -> torch.Tensor:
    """One optimizer step on ``batch`` in ``view`` ("gc" or "gs"), train
    mode; returns the loss (detached)."""
    model.train()
    opt.zero_grad(set_to_none=True)
    out = _forward(model, batch, view, generator)
    loss = _graph_loss(out, batch.y, classify, prop, _mask_of(batch))
    loss.backward()
    opt.step()
    return loss.detach()


def graph_eval_step(model: GraphModel, batch: GraphLevelBatch,
                    classify: bool, prop: Optional[int], view: str):
    """Eval-mode (loss, metric) of one batch: accuracy, or the L1 over the
    std of the batch's targets."""
    model.eval()
    with torch.no_grad():
        out = _forward(model, batch, view)
        mask = _mask_of(batch)
        loss = _graph_loss(out, batch.y, classify, prop, mask)
        s, c = _graph_metric_sums(out, batch.y, mask, classify, prop)
        metric = s / c.clamp_min(1.0)
        if not classify:
            metric = metric / _target(batch.y, prop).float().std(
                correction=0).clamp_min(1e-12)
        return loss, metric


def graph_eval_sums(model: GraphModel, batch: GraphLevelBatch,
                    classify: bool, prop: Optional[int], view: str):
    """(loss sum, metric sum, count) of one batch, eval mode, for
    aggregation over chunks."""
    model.eval()
    with torch.no_grad():
        out = _forward(model, batch, view)
        mask = _mask_of(batch)
        ls, c = _graph_loss_sums(out, batch.y, mask, classify, prop)
        ms, _ = _graph_metric_sums(out, batch.y, mask, classify, prop)
        return ls, ms, c


@dataclasses.dataclass
class GraphTaskConfig:
    layer_name: str = "GCNConv"
    hidden: int = 64
    num_layers: int = 2
    out_dim: int = 2
    classify: bool = True
    exp_setup: str = "Gc_train_2_Gc_infer"
    epochs1: int = 100
    epochs2: int = 100
    lr: float = 0.01
    weight_decay: float = 5e-4
    prop: Optional[int] = None     # multi_prop property selector (QM9)
    seed: int = 0
    batch_size: int = 0            # the chunk size the splits were
                                   # collated at (recorded only)
    save_path: Optional[str] = None  # where the best parameters go
    device: str = "cuda"           # "cpu" only when asked


@dataclasses.dataclass
class GraphTaskResult:
    best_test_loss: float
    best_test_acc: float
    # wall seconds of each epoch: the train steps and the val eval (Gc),
    # the train steps and the val and test evals (Gs), to the values
    gc_epoch_seconds: List[float] = dataclasses.field(default_factory=list)
    gs_epoch_seconds: List[float] = dataclasses.field(default_factory=list)


def _as_batches(b) -> list:
    return [b] if isinstance(b, GraphLevelBatch) else list(b)


def _reg_norm(batches, prop: Optional[int]) -> float:
    """The std (numpy's, population) of the split's real targets over
    every chunk, once on the host: regression metrics are divided by it
    (the reference normalizes by the label std)."""
    vals = []
    for b in batches:
        y = b.y.cpu().numpy()
        if prop is not None:
            y = y[:, prop]
        vals.append(y[b.graph_mask.cpu().numpy()])
    return float(max(np.std(np.concatenate(vals)), 1e-12))


def _epoch_generator(device: torch.device, seed: int,
                     fold: int) -> torch.Generator:
    """The dropout generator of one epoch, seeded from (seed, fold)."""
    s = int(np.random.SeedSequence([seed, fold]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(s)


def run_graph_task(cfg: GraphTaskConfig, train_b, val_b, test_b,
                   verbose: bool = False) -> GraphTaskResult:
    """Train and evaluate ``cfg.exp_setup`` on ``cfg.device``.
    ``train_b`` / ``val_b`` / ``test_b``: a ``GraphLevelBatch`` or a list
    of same-shaped chunks, anywhere; they move to the device once.  The
    model starts from flax's init drawn from ``cfg.seed``; the best
    parameters by val loss go to ``cfg.save_path`` when it is set."""
    if cfg.exp_setup not in GRAPH_EXP_SETUPS:
        raise ValueError(f"exp_setup must be one of {GRAPH_EXP_SETUPS}")
    device = resolve_device(cfg.device)
    train_bs, val_bs, test_bs = (_as_batches(train_b), _as_batches(val_b),
                                 _as_batches(test_b))
    # the regression metrics' per-split label std (reference run.py:110)
    norms = {} if cfg.classify else {
        "val": _reg_norm(val_bs, cfg.prop),
        "test": _reg_norm(test_bs, cfg.prop)}
    train_bs = [b.to(device) for b in train_bs]
    splits = {"val": [b.to(device) for b in val_bs],
              "test": [b.to(device) for b in test_bs]}

    model = GraphModel(cfg.layer_name, in_dim=train_bs[0].gc.x.shape[1],
                       hidden=cfg.hidden, num_layers=cfg.num_layers,
                       out_dim=cfg.out_dim, classify=cfg.classify)
    model.reset_parameters(torch.Generator().manual_seed(cfg.seed))
    model = model.to(device)
    opt = adam_l2(model.parameters(), cfg.lr, cfg.weight_decay)

    def snapshot():
        return {k: v.detach().clone() for k, v in model.state_dict().items()}

    def train_epoch(fold: int, view: str) -> None:
        gen = _epoch_generator(device, cfg.seed, fold)
        for b in train_bs:
            graph_train_step(model, opt, b, gen, cfg.classify, cfg.prop,
                             view)

    def eval_split(split: str, view: str):
        sums = torch.stack([torch.stack(graph_eval_sums(
            model, b, cfg.classify, cfg.prop, view)) for b in splits[split]])
        # one read a split; the chunks add up in float64, as the JAX
        # package's Python floats do
        ls, ms, c = (float(v) for v in sums.cpu().double().sum(0))
        c = max(c, 1.0)
        metric = ms / c if cfg.classify else (ms / c) / norms[split]
        return ls / c, metric

    best = {"val": np.inf, "test_loss": np.inf, "test_acc": 0.0}
    best_params = snapshot()
    res = GraphTaskResult(best_test_loss=np.inf, best_test_acc=0.0)

    def track(val_loss, test_loss, test_acc) -> bool:
        if val_loss < best["val"]:
            best.update(val=val_loss, test_loss=test_loss, test_acc=test_acc)
            return True
        return False

    def decompose(tag, ep_times):
        if verbose and len(ep_times) > 1:
            steady = float(np.median(ep_times[1:]))
            print(f"[{tag}] decomposition: first epoch {ep_times[0]:.1f}s, "
                  f"steady {steady:.2f}s/epoch (median of "
                  f"{len(ep_times) - 1})", flush=True)

    setup = cfg.exp_setup
    if setup in ("Gc_train_2_Gc_infer", "Gc_train_2_Gs_infer",
                 "Gc_train_2_Gs_train"):
        t0 = time.perf_counter()
        for epoch in range(cfg.epochs1):
            train_epoch(epoch, "gc")
            val_loss, _ = eval_split("val", "gc")
            t1 = time.perf_counter()
            res.gc_epoch_seconds.append(t1 - t0)
            t0 = t1
            if verbose:
                print(f"[Gc graph] epoch {epoch}: val={val_loss:.4f} "
                      f"{res.gc_epoch_seconds[-1]:.1f}s", flush=True)
            if setup == "Gc_train_2_Gc_infer":
                test_loss, test_acc = eval_split("test", "gc")
                if track(val_loss, test_loss, test_acc):
                    best_params = snapshot()
            elif val_loss < best["val"] or epoch == 0:
                best["val"] = val_loss
                best_params = snapshot()
        decompose("Gc graph", res.gc_epoch_seconds)

    if setup == "Gc_train_2_Gs_infer":
        # weight transfer (the same parameters), then the Gs view
        model.load_state_dict(best_params)
        best["test_loss"], best["test_acc"] = eval_split("test", "gs")

    if setup in ("Gs_train_2_Gs_infer", "Gc_train_2_Gs_train"):
        if setup == "Gc_train_2_Gs_train":
            # the best Gc parameters; Adam's state carries over
            model.load_state_dict(best_params)
        best["val"] = np.inf
        t0 = time.perf_counter()
        for epoch in range(cfg.epochs2):
            train_epoch(10_000 + epoch, "gs")
            val_loss, _ = eval_split("val", "gs")
            test_loss, test_acc = eval_split("test", "gs")
            t1 = time.perf_counter()
            res.gs_epoch_seconds.append(t1 - t0)
            t0 = t1
            if verbose:
                print(f"[Gs graph] epoch {epoch}: val={val_loss:.4f} "
                      f"test={test_loss:.4f} acc={test_acc:.4f} "
                      f"{res.gs_epoch_seconds[-1]:.1f}s", flush=True)
            if track(val_loss, test_loss, test_acc):
                best_params = snapshot()
        decompose("Gs graph", res.gs_epoch_seconds)

    if cfg.save_path is not None:
        ckpt.save_params(cfg.save_path, best_params)
    res.best_test_loss = best["test_loss"]
    res.best_test_acc = best["test_acc"]
    return res
