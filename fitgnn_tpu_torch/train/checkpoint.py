"""Checkpoints, in the port's own format: ``torch.save`` written
atomically, read back with ``weights_only=True``.

* ``save_params`` / ``restore_params``: a ``NodeModel`` state dict, the
  ``model.pt`` that ``train`` and ``train --baseline`` write and ``infer``
  and ``infer-baseline`` read.
* ``save_checkpoint`` / ``restore_checkpoint``: the parameters, the
  optimizer state and its step.
* ``save_resume`` / ``load_resume``: everything the curriculum loop needs
  to continue a killed session as the uninterrupted one would have gone
  on, as the JAX package's resume checkpoint holds it: the model and Adam
  state, the best parameters and val loss, the dropout generator's state,
  the phase / epoch / run cursor, ``since_best``, the completed runs'
  (loss, metric, seconds) and the configuration's fingerprint.  It lives
  in ``<resume_path>/state.pt``; nothing else there is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, Optional

import torch

RESUME_FILE = "state.pt"
PHASES = ("gc", "gs")


def _cpu(state: Mapping) -> dict:
    return {k: v.detach().cpu() for k, v in state.items()}


def _atomic_save(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _load(path: str):
    return torch.load(path, map_location="cpu", weights_only=True)


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (moved to the CPU) to ``path``, creating its
    directory; the file is replaced atomically."""
    _atomic_save(path, _cpu(state_dict))


def restore_params(path: str) -> dict:
    """The state dict at ``path``, on the CPU."""
    return _load(path)


def optimizer_step(opt: torch.optim.Optimizer) -> int:
    """The optimizer's step count (Adam's per-parameter ``step``; 0 before
    the first)."""
    steps = [int(s["step"]) for s in opt.state.values() if "step" in s]
    return max(steps, default=0)


def save_checkpoint(path: str, model: torch.nn.Module,
                    opt: torch.optim.Optimizer) -> None:
    """Parameters, optimizer state and step at ``path``."""
    _atomic_save(path, {"params": _cpu(model.state_dict()),
                        "opt_state": opt.state_dict(),
                        "step": optimizer_step(opt)})


def restore_checkpoint(path: str, model: torch.nn.Module,
                       opt: torch.optim.Optimizer) -> int:
    """Load ``path`` into ``model`` and ``opt`` (built as they were
    saved); returns the step."""
    ckpt = _load(path)
    model.load_state_dict(ckpt["params"])
    opt.load_state_dict(ckpt["opt_state"])
    return int(ckpt["step"])


@dataclasses.dataclass
class ResumePoint:
    """A resume checkpoint as loaded: tensors on the CPU."""

    model: dict                  # the model's state dict
    optimizer: dict              # the optimizer's state dict
    best_state: dict             # the best parameters so far
    best_val: float
    generator: torch.Tensor      # the dropout generator's ``get_state()``
    phase: str                   # "gc" or "gs"
    epoch: int                   # the last epoch done (-1: none yet)
    run: int
    since_best: int
    done: List[List[float]]      # completed runs' (loss, metric, seconds)


def save_resume(path: str, model: torch.nn.Module,
                opt: torch.optim.Optimizer, best_state: Mapping,
                best_val: float, generator: torch.Generator, phase: str,
                epoch: int, run: int, done: List[List[float]],
                since_best: int = 0, config_fp: int = 0) -> None:
    """Write the session's state to ``<path>/state.pt``."""
    _atomic_save(os.path.join(path, RESUME_FILE), {
        "config_fp": int(config_fp),
        "model": _cpu(model.state_dict()),
        "optimizer": opt.state_dict(),
        "best_state": _cpu(best_state),
        "best_val": float(best_val),
        "generator": generator.get_state(),
        "phase": PHASES.index(phase),
        "epoch": int(epoch), "run": int(run),
        "since_best": int(since_best),
        "done": [[float(v) for v in row] for row in done]})


def load_resume(path: str, config_fp: int = 0) -> Optional[ResumePoint]:
    """The checkpoint in ``path``, or None when there is none.  Raises when
    it was written under another configuration (another fingerprint)."""
    f = os.path.join(path, RESUME_FILE)
    if not os.path.exists(f):
        return None
    r = _load(f)
    if config_fp and r["config_fp"] and r["config_fp"] != config_fp:
        raise ValueError(
            "resume checkpoint was written under a DIFFERENT config "
            "(seed/epochs/model/schedule): continuing would produce "
            "results belonging to neither; delete the resume dir or "
            "rerun with the original flags")
    return ResumePoint(
        model=r["model"], optimizer=r["optimizer"],
        best_state=r["best_state"], best_val=r["best_val"],
        generator=r["generator"], phase=PHASES[r["phase"]],
        epoch=r["epoch"], run=r["run"], since_best=r["since_best"],
        done=r["done"])
