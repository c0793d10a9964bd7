"""Model checkpoints: a ``NodeModel`` state dict written with
``torch.save``, the file ``infer-baseline`` reads
(``save/<task>/baseline/<output_dir>/model.pt``).  Optimizer state and the
resume cursor are not ported yet (ROADMAP.md §1 item 2)."""

from __future__ import annotations

import os
from typing import Mapping

import torch


def save_params(path: str, state_dict: Mapping[str, torch.Tensor]) -> None:
    """Write ``state_dict`` (moved to the CPU) to ``path``, creating its
    directory; the file is replaced atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, tmp)
    os.replace(tmp, path)


def restore_params(path: str) -> dict:
    """The state dict at ``path``, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
