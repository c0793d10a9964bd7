"""Parameters trained by the JAX package → the port's ``NodeModel`` or
``GraphModel`` (the same keys: ``convs/<Layer>_<i>`` and ``head``)."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

# per layer: the port's state-dict suffix → (flax path, transposed)
_LAYER_PARAMS = {
    "GCNConv": {"lin.weight": (("lin", "kernel"), True),
                "bias": (("bias",), False)},
    "GATConv": {"lin.weight": (("lin", "kernel"), True),
                "att_src": (("att_src",), False),
                "att_dst": (("att_dst",), False),
                "bias": (("bias",), False)},
    "SAGEConv": {"lin_l.weight": (("lin_l", "kernel"), True),
                 "lin_l.bias": (("lin_l", "bias"), False),
                 "lin_r.weight": (("lin_r", "kernel"), True)},
    "GINConv": {"eps": (("eps",), False),
                "mlp_0.weight": (("mlp_0", "kernel"), True),
                "mlp_0.bias": (("mlp_0", "bias"), False),
                "mlp_1.weight": (("mlp_1", "kernel"), True),
                "mlp_1.bias": (("mlp_1", "bias"), False)},
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_flax(tree: Mapping) -> dict:
    """Map a flax ``NodeModel`` or ``GraphModel`` parameter tree (GCN,
    GAT, SAGE or GIN,
    pre-aggregated or not: the trees are the same; nested mappings of numpy
    arrays, with or without the top-level ``params`` key) onto the port's
    state dict.  flax kernels are (in, out); ``nn.Linear`` stores (out,
    in), so kernels are transposed; GIN's ``eps`` stays 0-dim.  The layer
    type comes from the tree's ``<layer>_0`` key."""
    p = tree["params"] if "params" in tree else tree
    convs = p["convs"]
    layer_name = next((name for name in _LAYER_PARAMS
                       if f"{name}_0" in convs), None)
    if layer_name is None:
        raise ValueError(f"no {'/'.join(_LAYER_PARAMS)}_<i> layers under "
                         f"params/convs (found {sorted(convs)})")
    sd = {}
    i = 0
    while f"{layer_name}_{i}" in convs:
        layer = convs[f"{layer_name}_{i}"]
        for name, (path, transpose) in _LAYER_PARAMS[layer_name].items():
            v = layer
            for key in path:
                v = v[key]
            sd[f"convs.layers.{i}.{name}"] = _t(v).T if transpose else _t(v)
        i += 1
    sd["head.weight"] = _t(p["head"]["kernel"]).T
    sd["head.bias"] = _t(p["head"]["bias"])
    return {k: v.contiguous() for k, v in sd.items()}
