"""Inputs shared by the distributed curriculum's parity tests
(``test_torch_port_dist_curriculum*.py``): the JAX tests' seeded SBM
graph (300 nodes, 4 classes) and regression graph (240 nodes), each
generated by the port's generator and by the JAX package's and partitioned
by both packages (``variation_neighborhoods``, ratio 0.5, ``extra_node``;
one batch or size buckets), the JAX package's initial parameters of a
2-layer, hidden-16 ``NodeModel`` as the port's state dict, and the
tolerance.
"""

import functools

import numpy as np

import jax

from fitgnn_tpu.data import synthetic as jax_synthetic
from fitgnn_tpu.data.splits import (
    splits_classification as jax_splits_classification,
    splits_regression as jax_splits_regression)
from fitgnn_tpu.models import NodeModel as JaxNodeModel
from fitgnn_tpu.partition import coarsen_and_partition as jax_partition
from fitgnn_tpu.train import steps as jax_steps

from fitgnn_tpu_torch.data import synthetic
from fitgnn_tpu_torch.data.splits import (splits_classification,
                                          splits_regression)
from fitgnn_tpu_torch.models.convert import params_from_flax
from fitgnn_tpu_torch.partition.pipeline import coarsen_and_partition

HIDDEN = 16
CLASSES = 4
LR, WD = 0.01, 5e-4


def close(got, ref, what=""):
    """rtol 1e-4, atol 1e-4·max|ref| (f32 sums in another order)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * scale,
                               err_msg=what)


def _graph(task, gen, splits_cls, splits_reg):
    if task == "classification":
        x, s, r, y = gen.sbm_graph(num_nodes=300, num_classes=CLASSES,
                                   num_features=32, p_in=0.08, p_out=0.004,
                                   feature_noise=1.5, seed=0)
        return (x, s, r, y), splits_cls(y, CLASSES, "random", seed=0)
    x, s, r, y = gen.random_regression_graph(num_nodes=240, num_features=16,
                                             seed=0)
    return (x, s, r, y), splits_reg(240, 0.3, 0.2, seed=0)


@functools.lru_cache(maxsize=None)
def partitions(task, bucket=False):
    """(the port's partition, the JAX package's) of ``task``'s graph, each
    package's generator and splits feeding its own partition."""
    out = []
    for gen, part, sc, sr in (
            (synthetic, coarsen_and_partition, splits_classification,
             splits_regression),
            (jax_synthetic, jax_partition, jax_splits_classification,
             jax_splits_regression)):
        (x, s, r, y), (tr, va, te) = _graph(task, gen, sc, sr)
        kw = dict(num_classes=CLASSES) if task == "classification" else {}
        out.append(part(x, s, r, y, reduction=0.5,
                        method="variation_neighborhoods", mode="extra_node",
                        task=task, train_mask=tr, val_mask=va, test_mask=te,
                        seed=0, bucket=bucket, **kw))
    return tuple(out)


def batches_of(part):
    b = part.subgraphs
    return (b,) if hasattr(b, "num_subgraphs") else tuple(b)


def out_dim(task):
    return CLASSES if task == "classification" else 1


@functools.lru_cache(maxsize=None)
def jax_params(layer, task):
    """The JAX package's initial parameters (``create_state``, key 0) of a
    dropout-0 ``NodeModel``."""
    _, jpart = partitions(task)
    jm = JaxNodeModel(layer_name=layer, hidden=HIDDEN, num_layers=2,
                      out_dim=out_dim(task),
                      classify=task == "classification", dropout_rate=0.0)
    g0 = batches_of(jpart)[0].subgraph(0)
    return jax_steps.create_state(jm, jax.random.PRNGKey(0), g0.x, g0,
                                  lr=LR, weight_decay=WD)


def port_params(params) -> dict:
    """A JAX parameter tree as the port's state dict, numpy arrays."""
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)).items()}


def assert_params_close(got: dict, params, what=""):
    ref = port_params(params)
    assert set(got) == set(ref)
    for k, v in ref.items():
        close(got[k], v, f"{what} {k}")
