"""Parameters trained by the JAX package → the port's ``NodeModel``."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_flax(tree: Mapping) -> dict:
    """Map a flax GCN ``NodeModel`` parameter tree (nested mappings of numpy
    arrays, with or without the top-level ``params`` key) onto the port's
    state dict.  flax ``Dense`` kernels are (in, out); ``nn.Linear``
    stores (out, in), so kernels are transposed."""
    p = tree["params"] if "params" in tree else tree
    layer_name = "GCNConv"
    convs = p["convs"]
    sd = {}
    i = 0
    while f"{layer_name}_{i}" in convs:
        layer = convs[f"{layer_name}_{i}"]
        sd[f"convs.layers.{i}.lin.weight"] = _t(layer["lin"]["kernel"]).T
        sd[f"convs.layers.{i}.bias"] = _t(layer["bias"])
        i += 1
    if i == 0:
        raise ValueError(f"no {layer_name}_<i> layers under params/convs")
    sd["head.weight"] = _t(p["head"]["kernel"]).T
    sd["head.bias"] = _t(p["head"]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
