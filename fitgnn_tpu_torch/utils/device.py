"""Device selection and movement of the port's containers."""

from __future__ import annotations

import dataclasses

import torch


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) raises when no GPU is visible: the port never drops to
    the CPU on its own.  On the GPU float32 matmuls stay full float32
    (TF32 off), matching the JAX reference's f32 dense layers."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r} (cuda or cpu)")
    return dev


def to_device(v, device):
    """Move a tensor, or a container with a ``.to(device)`` method;
    ``None`` and plain values pass through."""
    if v is None or isinstance(v, (int, float, str, bool)):
        return v
    return v.to(device)


def dataclass_to(obj, device):
    """``dataclasses.replace`` with every field moved to ``device``; a
    field that ``__post_init__`` makes is made anew of the moved ones."""
    return dataclasses.replace(obj, **{
        f.name: to_device(getattr(obj, f.name), device)
        for f in dataclasses.fields(obj) if f.init})
