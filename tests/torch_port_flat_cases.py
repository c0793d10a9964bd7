"""The inputs of the flat data-mesh parity tests
(``test_torch_port_flat.py``, ``test_torch_port_flat_steps.py``): a
community graph sharded over 4 ranks, both sides' plans, the port's
layer parameters as a flax tree, and the comparison's tolerance (rtol
1e-4, atol 1e-4·max|ref|)."""

import numpy as np

import jax.numpy as jnp

from fitgnn_tpu_torch.models.convert import _LAYER_PARAMS
from fitgnn_tpu_torch.parallel import LAYER_SEMANTICS, shard_graph

P = 4
LAYERS = ("GCNConv", "SAGEConv", "GINConv", "GATConv")


def graph(task="classification", n=256, comm=32, f=12, seed=11):
    """A community graph (70% of the edges inside 32-node blocks) with
    labels or a smooth target and train / val masks."""
    rng = np.random.default_rng(seed)
    e = n * 6
    r = rng.integers(0, n, e)
    s = np.where(rng.random(e) < 0.7, (r // comm) * comm
                 + rng.integers(0, comm, e), rng.integers(0, n, e))
    keep = s != r
    x = rng.standard_normal((n, f)).astype(np.float32)
    if task == "classification":
        y = ((np.arange(n) // comm) % 3).astype(np.int32)
    else:
        y = (x[:, 0] + 0.1 * rng.standard_normal(n)).astype(np.float32)
    split = rng.random(n)
    return (x, s[keep], r[keep], y, split < 0.4,
            (split >= 0.4) & (split < 0.7))


def sharded(layer, task="classification", shards=P):
    """The port's ShardedGraph of ``graph(task)`` under the layer's
    semantics (the JAX package's, ``test_torch_port_hier.py`` holds)."""
    x, s, r, y, train, val = graph(task)
    return shard_graph(x, s, r, y, shards, train_mask=train, val_mask=val,
                       semantics=LAYER_SEMANTICS[layer])


def to_flax(layer, state):
    """A layer's state dict (numpy) as the JAX layer's variables."""
    tree = {}
    for name, (path, transpose) in _LAYER_PARAMS[layer].items():
        v = state[name].T if transpose else state[name]
        d = tree
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = jnp.asarray(v)
    return {"params": tree}


def close(got, ref, what):
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), ref, rtol=1e-4,
        atol=1e-4 * max(float(np.abs(ref).max(initial=0.0)), 1e-30),
        err_msg=what)
